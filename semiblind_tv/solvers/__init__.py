from semiblind_tv.solvers.salsa import SALSAResult, salsa_tv, soft_threshold  # noqa: F401
from semiblind_tv.solvers.fista import FISTAResult, fista, fista_tv  # noqa: F401
from semiblind_tv.solvers.csalsa import CSALSAResult, csalsa, csalsa_synthesis, csalsa_tv  # noqa: F401
from semiblind_tv.solvers.coral import CoRALResult, coral, coral_tv_l1  # noqa: F401
from semiblind_tv.solvers.nesta import NESTAResult, nesta  # noqa: F401
from semiblind_tv.solvers.spgl1 import SPGL1Result, spg_lasso, spgl1_bpdn  # noqa: F401

from semiblind_tv.runtime.config import (  # noqa: F401
    SAPGConfig,
    SALSAConfig,
    DemoConfig,
    gaussian_preset,
    laplace_preset,
    moffat_preset,
    isotropic_preset,
    preset,
)
from semiblind_tv.runtime.problem import Problem, build_problem, synthesize_observation  # noqa: F401

from semiblind_tv.sapg.estimator import SAPGResult, run_sapg  # noqa: F401

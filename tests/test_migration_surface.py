"""Pin the public API surface documented in MIGRATION.md.

Every name the migration guide tells a reference user to call must exist
and be callable — this test fails the moment a rename/move makes the
guide stale.  (Behavior is covered by the per-module test files; this is
purely the documented-surface contract.)
"""
import importlib
import inspect

import pytest

# (module, attribute) pairs exactly as MIGRATION.md spells them.
DOCUMENTED = [
    # demos / drivers
    ("semiblind_tv.cli.run_demo", "run_demo"),
    ("semiblind_tv.cli.run_demo", "main"),
    ("semiblind_tv.cli.oracle_sweep", "main"),
    ("semiblind_tv.cli.run_wavelet_l1", "main"),
    ("semiblind_tv.cli.run_sharded", "main"),
    # estimator API
    ("semiblind_tv.runtime", "build_problem"),
    ("semiblind_tv.runtime", "gaussian_preset"),
    ("semiblind_tv.runtime", "laplace_preset"),
    ("semiblind_tv.runtime", "moffat_preset"),
    ("semiblind_tv.sapg", "run_sapg"),
    # solver zoo
    ("semiblind_tv.solvers.salsa_generic", "salsa"),
    ("semiblind_tv.solvers.salsa_generic", "salsa_v1"),
    ("semiblind_tv.solvers.salsa", "salsa_tv"),
    ("semiblind_tv.solvers.salsa", "soft_threshold"),
    ("semiblind_tv.solvers.csalsa", "csalsa"),
    ("semiblind_tv.solvers.csalsa", "csalsa_tv"),
    ("semiblind_tv.solvers.csalsa", "csalsa_synthesis"),
    ("semiblind_tv.solvers.coral", "coral"),
    ("semiblind_tv.solvers.coral", "coral_tv_l1"),
    ("semiblind_tv.solvers.nesta", "nesta"),
    ("semiblind_tv.solvers.spgl1", "spg_lasso"),
    ("semiblind_tv.solvers.spgl1", "spgl1_bpdn"),
    ("semiblind_tv.solvers.fista", "fista"),
    ("semiblind_tv.solvers.fista", "fista_tv"),
    ("semiblind_tv.samplers.myula", "myula_sampler"),
    ("semiblind_tv.samplers.myula", "myula_kernel_step"),
    # operators / prox / wavelets / utilities
    ("semiblind_tv.ops.tv", "chambolle_prox"),
    ("semiblind_tv.ops.tv", "tv_norm"),
    ("semiblind_tv.ops.tv", "tv_denoise_circular"),
    ("semiblind_tv.ops.tv", "projk_denoise"),
    ("semiblind_tv.ops.psf", "gaussian_kernel"),
    ("semiblind_tv.ops.psf", "laplace_kernel"),
    ("semiblind_tv.ops.psf", "moffat_kernel"),
    ("semiblind_tv.ops.psf", "gaussian_kernel_grads"),
    ("semiblind_tv.ops.psf", "laplace_kernel_grads"),
    ("semiblind_tv.ops.psf", "moffat_kernel_grads"),
    ("semiblind_tv.ops.fourier", "otf_rfft"),
    ("semiblind_tv.ops.fourier", "otf_fft"),
    ("semiblind_tv.ops.fourier", "BlurOperator"),
    ("semiblind_tv.ops.lipschitz", "power_iteration"),
    ("semiblind_tv.ops.wavelet", "daubcqf"),
    ("semiblind_tv.ops.wavelet", "ti_analysis"),
    ("semiblind_tv.ops.wavelet", "ti_synthesis"),
    ("semiblind_tv.ops.wavelet", "uniform_blur_kernel"),
    ("semiblind_tv.metrics.metrics", "mse_db"),
    ("semiblind_tv.metrics.metrics", "psnr"),
    ("semiblind_tv.metrics.metrics", "snr"),
    ("semiblind_tv.metrics.metrics", "ssim"),
    ("semiblind_tv.utils.signals", "calctv"),
    ("semiblind_tv.utils.signals", "monotonize"),
    ("semiblind_tv.utils.signals", "sparse_pws"),
    ("semiblind_tv.utils.signals", "make_rd_squares"),
    ("semiblind_tv.utils.signals", "vectorized_operator"),
    ("semiblind_tv.utils.signals", "ensure"),
    ("semiblind_tv.runtime.profiling", "CallCounter"),
    # flat re-exports the guide's solver-zoo table relies on
    ("semiblind_tv.solvers", "salsa_tv"),
    ("semiblind_tv.solvers", "csalsa"),
    ("semiblind_tv.solvers", "csalsa_tv"),
    ("semiblind_tv.solvers", "csalsa_synthesis"),
    ("semiblind_tv.solvers", "coral"),
    ("semiblind_tv.solvers", "coral_tv_l1"),
    ("semiblind_tv.solvers", "nesta"),
    ("semiblind_tv.solvers", "spg_lasso"),
    ("semiblind_tv.solvers", "spgl1_bpdn"),
    ("semiblind_tv.solvers", "fista"),
    ("semiblind_tv.solvers", "fista_tv"),
    ("semiblind_tv.solvers", "soft_threshold"),
    ("semiblind_tv.runtime", "isotropic_preset"),
]


@pytest.mark.parametrize("module,attr", DOCUMENTED, ids=lambda v: str(v))
def test_documented_name_exists(module, attr):
    obj = getattr(importlib.import_module(module), attr)
    assert callable(obj) or inspect.isclass(obj)


def test_run_sapg_documented_kwargs():
    """MIGRATION.md documents these run_sapg kwargs — keep them stable."""
    from semiblind_tv.sapg import run_sapg

    params = inspect.signature(run_sapg).parameters
    for kw in ("n_chains", "mesh", "checkpoint_every", "checkpoint_path"):
        assert kw in params


# Call shapes the guide spells out, not just name existence:
# every kwarg MIGRATION.md writes in a `name=` position must be a real
# parameter of the documented callable.
DOCUMENTED_KWARGS = [
    ("semiblind_tv.solvers.salsa_generic", "salsa",
     ("A", "AT", "inv_ls", "tau", "mu", "prox", "phi", "P", "PT")),
    ("semiblind_tv.solvers.salsa_generic", "salsa_v1",
     ("A", "AT", "inv_ls", "tau", "mu", "inner_iters")),
    ("semiblind_tv.solvers.csalsa", "csalsa",
     ("A", "AT", "invLS", "mu1", "mu2", "epsilon")),
    ("semiblind_tv.solvers.salsa", "salsa_tv", ("tau", "mu", "blur")),
]


@pytest.mark.parametrize("module,attr,kwargs", DOCUMENTED_KWARGS,
                         ids=lambda v: str(v))
def test_documented_call_shape(module, attr, kwargs):
    fn = getattr(importlib.import_module(module), attr)
    params = inspect.signature(fn).parameters
    for kw in kwargs:
        assert kw in params, f"{module}.{attr} lost documented kwarg {kw!r}"


def test_oracle_sweep_documented_cli_flags():
    """MIGRATION.md maps salsa_m/salsa_m_sigma to these flags."""
    from semiblind_tv.cli import oracle_sweep

    parser = oracle_sweep.build_parser()
    opts = {s for a in parser._actions for s in a.option_strings}
    for flag in ("--tau-grid", "--sigma-grid", "--grid", "--psf", "--image"):
        assert flag in opts, f"oracle_sweep lost documented flag {flag}"

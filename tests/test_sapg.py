"""SAPG estimator: one-step parity vs the spatial-domain NumPy oracle, plus
short end-to-end runs for every PSF family."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.runtime import build_problem, gaussian_preset, laplace_preset, moffat_preset
from semiblind_tv.sapg import run_sapg
from semiblind_tv.sapg.estimator import make_sapg_step
from semiblind_tv.utils import synthetic_wheel
from tests import oracles

SIZE = 32


def _image():
    return synthetic_wheel(SIZE)


def test_one_step_matches_spatial_oracle():
    """The fused rfft/Parseval step must equal the reference's spatial-domain
    math (A/Aᵀ via full fft2, spatial inner products) to fp accuracy."""
    cfg = gaussian_preset(fix_w1=False, fix_w2=False, fix_sigma=False)
    x = _image()
    key = jax.random.key(7)
    problem = build_problem(x, cfg, key, dtype=jnp.float64)
    step, aux = make_sapg_step(problem, n_chains=1)

    theta0 = jnp.float64(cfg.theta.init)
    sigma0 = problem.sigma2_init
    params0 = {k: jnp.float64(v) for k, v in cfg.init_psf_params().items()}
    X0 = problem.y[None]
    prox0, _ = aux["prox_b"](X0, aux["lam"] * theta0)

    keys0 = jax.random.split(jax.random.key(3), 1)  # one key per chain
    carry0 = (X0, jnp.fft.rfft2(X0), prox0, keys0, theta0, sigma0, params0, {})
    (X1, _, prox1, _, theta1, sigma1, params1, _), trace = step(carry0, jnp.asarray(2.0))

    # replicate the per-chain noise draw
    _, sub = jax.random.split(keys0[0])
    Z = np.asarray(jax.random.normal(sub, X0.shape[1:], jnp.float64))

    boxes = dict(
        theta=cfg.theta.box, w1=(0.1, 1.0), w2=(0.1, 1.0),
        sigma=(float(problem.sigma2_box[0]), float(problem.sigma2_box[1])),
    )
    oX1, oprox1, otheta1, ow1, ow2, osigma1, stats = oracles.np_sapg_gaussian_step(
        np.asarray(problem.y), np.asarray(prox0[0]), Z, np.asarray(problem.y),
        float(theta0), float(params0["w1"]), float(params0["w2"]), float(sigma0),
        cfg.psf_size, cfg.phi, float(problem.gamma), float(problem.lambda_myula),
        1.0, cfg.sapg.d_exp, 2,
        cfg.theta.step_scale, 10.0, 10.0, cfg.sigma_step_scale,
        boxes, dict(w1=False, w2=False, sigma=False),
        dict(w1=0.4, w2=0.3), float(problem.sigma2_init),
    )

    np.testing.assert_allclose(np.asarray(X1)[0], oX1, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(prox1)[0], oprox1, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(float(theta1), otheta1, rtol=1e-8)
    np.testing.assert_allclose(float(params1["w1"]), ow1, rtol=1e-8)
    np.testing.assert_allclose(float(params1["w2"]), ow2, rtol=1e-8)
    np.testing.assert_allclose(float(sigma1), osigma1, rtol=1e-8)
    np.testing.assert_allclose(float(trace["G_t"]), stats["G_t"], rtol=1e-8)
    np.testing.assert_allclose(float(trace["G_w1"]), stats["G_w1"], rtol=1e-6)
    np.testing.assert_allclose(float(trace["G_s"]), stats["G_s"], rtol=1e-6)
    np.testing.assert_allclose(float(trace["logPi"]), stats["logPi"], rtol=1e-8)


def _short(cfg):
    import dataclasses

    return dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=10, burn_in=30),
    )


def _run_family(cfg, n_chains=1):
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(2), n_chains=n_chains)
    assert res.thetas.shape == (cfg.sapg.samples,)
    assert np.all(np.isfinite(res.thetas))
    assert np.all(np.isfinite(res.logPiTrace))
    assert np.all(np.isfinite(res.err_psf))
    lo, hi = cfg.theta.box
    assert lo <= res.theta_EB <= hi
    assert res.X_last.shape == (n_chains, SIZE, SIZE)
    if cfg.sapg.positivity:
        assert np.all(res.X_last >= 0)  # positivity projection
    assert len(res.logPiTrace_warmup) == cfg.sapg.warmup
    assert len(res.mean_thetas) == cfg.sapg.samples - cfg.sapg.burn_in_resolved
    for name, tr in res.psf_param_traces.items():
        assert np.all(np.isfinite(tr))
    return res


def test_gaussian_short_run():
    res = _run_family(_short(gaussian_preset(fix_w1=False, fix_w2=False)))
    assert set(res.psf_params_EB) == {"w1", "w2"}


def test_gaussian_fixed_params_stay_true():
    res = _run_family(_short(gaussian_preset(fix_w1=True, fix_w2=True)))
    np.testing.assert_allclose(res.psf_param_traces["w1"][1:], 0.4)
    np.testing.assert_allclose(res.psf_param_traces["w2"][1:], 0.3)


def test_laplace_short_run():
    res = _run_family(_short(laplace_preset()))
    assert set(res.psf_params_EB) == {"b"}


def test_moffat_short_run():
    res = _run_family(_short(moffat_preset()))
    assert set(res.psf_params_EB) == {"alpha", "beta"}


def test_dft_mode_matches_fft_trajectory():
    """fft_mode='dft' (matmul DFT hot loop) must reproduce the fft-mode
    trajectory to f64 matmul accuracy — same math, different transform
    backend (ops/fourier.py::rfft2_matmul)."""
    import dataclasses

    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    cfg_dft = dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, fft_mode="dft")
    )
    x = _image()
    res_fft = run_sapg(build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64),
                       jax.random.key(2))
    res_dft = run_sapg(build_problem(x, cfg_dft, jax.random.key(1), dtype=jnp.float64),
                       jax.random.key(2))
    np.testing.assert_allclose(res_dft.thetas, res_fft.thetas, rtol=1e-9)
    np.testing.assert_allclose(res_dft.sigma2s, res_fft.sigma2s, rtol=1e-9)
    np.testing.assert_allclose(res_dft.X_last, res_fft.X_last, rtol=1e-7, atol=1e-9)
    for n in res_fft.psf_params_EB:
        np.testing.assert_allclose(
            res_dft.psf_param_traces[n], res_fft.psf_param_traces[n], rtol=1e-9
        )


def test_multi_chain_runs():
    res = _run_family(_short(gaussian_preset(fix_w1=False, fix_w2=False)), n_chains=3)
    assert res.X_last.shape[0] == 3


def test_fix_sigma():
    cfg = _short(gaussian_preset(fix_sigma=True))
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(2))
    np.testing.assert_allclose(res.sigma2s[1:], float(problem.sigma2_init), rtol=1e-12)


def test_theta_log_scale_algorithm1():
    """Algorithm-1 variant: eta=log(theta) SA updates, no positivity
    projection (SALSA/SAPG_algorithm_1.m:173-182)."""
    import dataclasses

    cfg = gaussian_preset(fix_w1=True, fix_w2=True)
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(
            cfg.sapg, samples=40, warmup=10, burn_in=30,
            theta_log_scale=True, positivity=False,
        ),
    )
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(2))
    assert np.all(np.isfinite(res.thetas))
    lo, hi = cfg.theta.box
    assert lo <= res.theta_EB <= hi
    # EB must be the geometric mean of the window
    w = res.thetas[cfg.sapg.burn_in - 1:]
    np.testing.assert_allclose(res.theta_EB, np.exp(np.mean(np.log(w))), rtol=1e-10)
    # without the abs() projection negative pixels can persist
    assert res.X_last.min() < 0 or True  # only checks it runs; sign not guaranteed


def test_checkpoint_resume_identical_trajectory(tmp_path):
    """A run interrupted and resumed from checkpoint must produce the exact
    same trajectory as an uninterrupted run."""
    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)

    res_full = run_sapg(problem, jax.random.key(2))

    ckpt = str(tmp_path / "sapg.npz")
    # segmented run with checkpoints every 7 iterations
    res_seg = run_sapg(problem, jax.random.key(2), checkpoint_every=7,
                       checkpoint_path=ckpt)
    np.testing.assert_allclose(res_seg.thetas, res_full.thetas, rtol=1e-12)
    np.testing.assert_allclose(res_seg.sigma2s, res_full.sigma2s, rtol=1e-12)

    # simulate preemption: re-run with the final checkpoint present resumes
    # (no main iterations left) and still reconstructs the full trace
    res_resume = run_sapg(problem, jax.random.key(2), checkpoint_every=7,
                          checkpoint_path=ckpt)
    np.testing.assert_allclose(res_resume.thetas, res_full.thetas, rtol=1e-12)


def test_checkpoint_orbax_backend(tmp_path):
    """Orbax-backed mid-run checkpointing reproduces the NPZ trajectory
    (same flat array schema, directory-per-checkpoint layout)."""
    from semiblind_tv.runtime.checkpoint import (
        delete_checkpoint,
        load_checkpoint_arrays,
    )

    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res_full = run_sapg(problem, jax.random.key(2))

    ckpt = str(tmp_path / "sapg_orbax")
    res_seg = run_sapg(problem, jax.random.key(2), checkpoint_every=7,
                       checkpoint_path=ckpt, checkpoint_backend="orbax")
    np.testing.assert_allclose(res_seg.thetas, res_full.thetas, rtol=1e-12)
    assert os.path.isdir(ckpt)

    # resume path (backend auto-detected from the directory layout)
    z = load_checkpoint_arrays(ckpt)
    assert "X" in z and any(k.startswith("trace/") for k in z)
    res_resume = run_sapg(problem, jax.random.key(2), checkpoint_every=7,
                          checkpoint_path=ckpt, checkpoint_backend="orbax")
    np.testing.assert_allclose(res_resume.thetas, res_full.thetas, rtol=1e-12)
    delete_checkpoint(ckpt)
    assert not os.path.exists(ckpt)


def test_isotropic_gaussian_family():
    """SIAM 4.2.1 capability: single-width isotropic Gaussian with
    Algorithm-1 SAPG (run_deblur_tv.m intent; that driver is broken in the
    reference)."""
    from semiblind_tv.runtime import isotropic_preset

    res = _run_family(_short(isotropic_preset()))
    assert set(res.psf_params_EB) == {"w"}
    # isotropic grad = dw1 + dw2 at w1=w2=w — cross-check vs autodiff
    from semiblind_tv.models import IsotropicGaussianPsfModel

    m = IsotropicGaussianPsfModel(7, dtype=jnp.float64)
    _, g = m.kernel_and_grads({"w": jnp.float64(0.5)})
    jac = jax.jacfwd(lambda w: m.kernel({"w": w}))(jnp.float64(0.5))
    np.testing.assert_allclose(g["w"], jac, rtol=1e-9, atol=1e-12)


def test_posterior_moments_welford():
    """Welford posterior mean/var over post-burn-in samples matches a direct
    computation... validated via a tiny run with burn_in early."""
    import dataclasses

    cfg = gaussian_preset(fix_w1=True, fix_w2=True)
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(
            cfg.sapg, samples=30, warmup=5, burn_in=10,
            track_posterior_moments=True,
        ),
    )
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(2))
    assert res.posterior_mean is not None
    assert res.posterior_mean.shape == (1, SIZE, SIZE)
    assert np.all(np.isfinite(res.posterior_mean))
    assert np.all(res.posterior_var >= 0)
    # count = samples - burn_in iterations contribute (ii = burn_in+1..samples)
    # mean should be close to X_last scale-wise (same chain)
    assert 0 < res.posterior_mean.mean() < 2 * max(res.X_last.mean(), 1.0)


def test_sigma_log_scale_extension():
    import dataclasses

    cfg = gaussian_preset(fix_w1=True, fix_w2=True)
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=10, burn_in=30,
                                 sigma_log_scale=True),
    )
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(1), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(2))
    lo, hi = float(problem.sigma2_box[0]), float(problem.sigma2_box[1])
    assert np.all(res.sigma2s >= lo - 1e-9) and np.all(res.sigma2s <= hi + 1e-9)
    assert np.all(np.isfinite(res.sigma2s))


def test_posterior_moments_exact_vs_bruteforce():
    """Welford moments must equal the brute-force mean/var over the
    post-burn-in sample trace, computed by replaying the identical chain."""
    import dataclasses

    cfg = gaussian_preset(fix_w1=True, fix_w2=True)
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(
            cfg.sapg, samples=24, warmup=4, burn_in=10,
            track_posterior_moments=True,
        ),
    )
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(9), dtype=jnp.float64)
    res = run_sapg(problem, jax.random.key(10))

    # replay: identical run without moments, collecting X per step via
    # segmented checkpointing (checkpoint_every=1 gives us nothing per-X;
    # instead re-run with the same keys using make_sapg_step manually)
    from semiblind_tv.sapg.estimator import make_sapg_step, problem_consts

    step, aux = make_sapg_step(problem, n_chains=1)
    consts = problem_consts(problem)
    theta = jnp.float64(cfg.theta.init)
    sigma = problem.sigma2_init
    params = {k: jnp.float64(v) for k, v in cfg.init_psf_params().items()}
    keys = jax.random.split(jax.random.key(10), 1)
    X = problem.y[None]
    prox, _ = aux["prox_b"](X, aux["lam"] * theta)
    Xhat = jnp.fft.rfft2(X)
    # warm-up replay
    carry_w = (X, Xhat, prox, keys)
    for _ in range(cfg.sapg.warmup - 1):
        carry_w, _ = aux["warm_step"](carry_w, None, consts)
    X, Xhat, prox, keys = carry_w
    extra0 = dict(
        pm_mean=jnp.zeros_like(X), pm_m2=jnp.zeros_like(X),
        pm_count=jnp.zeros((), jnp.float64),
    )
    carry = (X, Xhat, prox, keys, theta, sigma, params, extra0)
    xs = []
    for ii in range(2, cfg.sapg.samples + 1):
        carry, _ = step(carry, jnp.float64(ii))
        if ii > cfg.sapg.burn_in_resolved:
            xs.append(np.asarray(carry[0]))
    xs = np.stack(xs)
    np.testing.assert_allclose(res.posterior_mean, xs.mean(0), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(res.posterior_var, xs.var(0, ddof=1), rtol=1e-8, atol=1e-10)


def test_standalone_myula_sampler():
    """Parity with SALSA/myula.m: fixed-hyperparameter chain, returns last
    sample and chain mean; must stay finite and positive-projected."""
    from semiblind_tv.samplers import myula_sampler

    cfg = gaussian_preset()
    x = _image()
    problem = build_problem(x, cfg, jax.random.key(4), dtype=jnp.float64)
    H = problem.H_true

    def grad_f(v):
        return problem.blur.irfft(
            np.conj(H)[...] * (H * jnp.fft.rfft2(v) - jnp.asarray(problem.yhat))
        ) / problem.sigma2_init

    x_last, x_mean = myula_sampler(
        grad_f, problem.y, jax.random.key(5), n_steps=50,
        gamma=problem.gamma, lam=problem.lambda_myula, theta=0.01,
    )
    assert np.all(np.isfinite(x_last)) and np.all(np.isfinite(x_mean))
    assert x_last.shape == x.shape
    # the chain mean is smoother than a single sample
    from semiblind_tv.ops.tv import tv_norm
    assert float(tv_norm(jnp.asarray(x_mean))) < float(tv_norm(jnp.asarray(x_last)))


def test_fft_mode_auto_policy():
    """One transform policy on every backend: jnp.fft (cuFFT on the GPU) at
    every size; 'dft' only when asked for (the row-sharded estimator)."""
    from unittest import mock

    from semiblind_tv.runtime.problem import resolve_fft_mode

    for backend in ("gpu", "cpu"):
        with mock.patch.object(jax, "default_backend", return_value=backend):
            for size in (256, 512, 1024, 4096):
                assert resolve_fft_mode((size, size)) == "fft"
            cfg = _short(gaussian_preset())
            assert build_problem(_image(), cfg, jax.random.key(0)).blur.fft_mode == "fft"


def test_fft_precision_auto_is_highest_on_gpu():
    """Auto transform precision is HIGHEST on the GPU (Precision.HIGH is
    TF32 there); 'high' stays selectable; the spatial path agrees."""
    import dataclasses
    from unittest import mock

    from semiblind_tv.parallel.spatial import spatial_fft_precision
    from semiblind_tv.runtime.problem import resolve_fft_precision

    hi = jax.lax.Precision.HIGHEST
    with mock.patch.object(jax, "default_backend", return_value="gpu"):
        assert resolve_fft_precision() == hi
        assert spatial_fft_precision() == hi
        cfg = _short(gaussian_preset())
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, fft_mode="dft"))
        assert build_problem(_image(), cfg, jax.random.key(0)).blur.precision == hi
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, fft_precision="high"))
        blur = build_problem(_image(), cfg, jax.random.key(0)).blur
        assert blur.precision == jax.lax.Precision.HIGH

"""Statistical EB-recovery integration test (SURVEY §4 strategy (b)).

The reference's own quality control is convergence of the EB estimates
toward truth on seeded synthetic problems.  RNG streams differ from MATLAB
(SURVEY §7 risks), so parity is statistical: with the full reference
iteration budget on a 64² problem, assert the estimates land in tolerance
bands around truth and the MAP solve beats the observation by a clear
margin.  Runs in ~40 s on CPU (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv import metrics
from semiblind_tv.runtime import build_problem, gaussian_preset
from semiblind_tv.sapg import run_sapg
from semiblind_tv.solvers import salsa_tv
from semiblind_tv.utils import synthetic_wheel


def test_gaussian_demo_eb_recovery_and_map_quality():
    cfg = gaussian_preset()  # reference defaults: w1/w2 pinned, estimate θ and σ²
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(
            cfg.sapg, samples=20_000, warmup=15_000, burn_in=16_000
        ),
    )
    problem = build_problem(synthetic_wheel(64), cfg, jax.random.key(11), dtype=jnp.float32)
    res = run_sapg(problem, jax.random.key(12))

    sigma2_true = float(problem.sigma_true) ** 2
    sigma2_init = float(problem.sigma2_init)
    # σ² must move most of the way from its (far) init toward truth
    log_dist_init = abs(np.log(sigma2_init) - np.log(sigma2_true))
    log_dist_eb = abs(np.log(res.sigma2_EB) - np.log(sigma2_true))
    assert log_dist_eb < 0.45 * log_dist_init, (res.sigma2_EB, sigma2_true, sigma2_init)
    # θ lands in the physically sensible band the reference demos report
    assert 1e-3 < res.theta_EB < 0.1

    H = problem.blur.otf_host(
        problem.model.kernel({k: jnp.float32(v) for k, v in res.psf_params_EB.items()})
    )
    sal = salsa_tv(
        problem.y, H, res.theta_EB * res.sigma2_EB, res.theta_EB / 10.0,
        problem.blur, max_iter=500, tol=1e-5, tv_iters=10, x_true=problem.x_true,
    )
    mse_map = float(metrics.mse_db(problem.x_true, jnp.asarray(sal.x)))
    mse_obs = float(metrics.mse_db(problem.x_true, problem.y))
    assert mse_map < mse_obs - 2.5  # ≥2.5 dB deblurring gain
    ssim_map = float(metrics.ssim(problem.x_true, jnp.asarray(sal.x)))
    ssim_obs = float(metrics.ssim(problem.x_true, problem.y))
    assert ssim_map > ssim_obs + 0.1


def test_psf_log_scale_dynamics_match_numpy_oracle():
    """The opt-in log-space PSF update (run_demo --psf-log-scale) against the independent NumPy oracle carrying the same
    extension: both implementations (different RNG streams) must land on
    the same Laplace-scale endpoint, certifying the extension's dynamics
    the same way the linear default is certified."""
    import dataclasses as dc

    from tests import oracles
    from semiblind_tv.runtime import laplace_preset

    x = np.asarray(synthetic_wheel(64), dtype=np.float64)
    res_o = oracles.np_sapg_dynamics_run(
        x, "laplace", seed=5, samples=1500, warmup=750, psf_log_scale=True
    )

    cfg = laplace_preset()
    cfg = dc.replace(cfg, sapg=dc.replace(
        cfg.sapg, samples=1500, warmup=750, burn_in=1200, psf_log_scale=True
    ))
    problem = build_problem(synthetic_wheel(64), cfg, jax.random.key(41),
                            dtype=jnp.float64)
    res_r = run_sapg(problem, jax.random.key(42))

    b_o, b_r = res_o["b_EB"], res_r.psf_params_EB["b"]
    assert np.isfinite(b_r) and 1e-3 <= b_r <= 1.0
    # endpoints agree across implementations (log-space geometric closeness)
    assert abs(np.log(b_o / b_r)) < 0.4, (b_o, b_r)
    # θ endpoints agree to ~30% relative
    assert abs(res_o["theta_EB"] - res_r.theta_EB) < 0.3 * res_o["theta_EB"]


def test_moffat_dynamics_match_numpy_oracle():
    """Moffat drift certification.

    tests/oracles.py::np_sapg_dynamics_run is an independent NumPy
    re-implementation of the reference's Moffat SAPG (spatial-domain
    closures, its own RNG stream — anchor SAPG_algorithm_moffat.m:135-205 +
    run_moffat_demo.m:122-185, including the α-gradient factor-2 quirk).
    On the synthetic phantom both it and the JAX estimator must produce the
    same drift: β climbs from its init 10-box midpoint... (β_init = 10 is
    already at the box max; the drift keeps it pinned there — the same α–β
    profile-degeneracy direction seen at the 512² wheel.png operating point,
    RESULTS.md), α descends toward ~0.7, and σ² lands near truth.  Statistical
    agreement between two implementations with different RNGs certifies the
    drift is the method's behavior, not an implementation artifact.
    """
    import dataclasses as dc

    from tests import oracles
    from semiblind_tv.runtime import moffat_preset

    x = np.asarray(synthetic_wheel(64), dtype=np.float64)
    res_o = oracles.np_sapg_dynamics_run(x, "moffat", seed=3, samples=1500, warmup=750)

    cfg = moffat_preset()
    cfg = dc.replace(cfg, sapg=dc.replace(cfg.sapg, samples=1500, warmup=750, burn_in=1200))
    problem = build_problem(synthetic_wheel(64), cfg, jax.random.key(31), dtype=jnp.float64)
    res_r = run_sapg(problem, jax.random.key(32))

    # same β drift endpoint (pinned at the box max by the upward drift)
    assert res_o["beta_EB"] > 9.5 and res_r.psf_params_EB["beta"] > 9.5
    # α endpoints agree across implementations
    assert abs(res_o["alpha_EB"] - res_r.psf_params_EB["alpha"]) < 0.15
    # θ endpoints agree to ~30% relative
    assert abs(res_o["theta_EB"] - res_r.theta_EB) < 0.3 * res_o["theta_EB"]
    # σ² lands near truth in both (the well-posed axis at this size)
    s2t = res_o["sigma2_true"]
    assert abs(np.log(res_o["sigma2_EB"] / s2t)) < 0.35
    s2t_r = float(problem.sigma_true) ** 2
    assert abs(np.log(res_r.sigma2_EB / s2t_r)) < 0.35


def test_laplace_estimation_stays_well_posed():
    """Laplace family at 64² with dimension-rescaled SA constants.

    PSF-scale recovery at 64² is NOT expected: the reference's operating
    point (512², its c_b/c_σ/10×γ constants) is where b-recovery happens;
    at 64² the semi-blind problem is degenerate and b drifts toward the
    no-blur end whatever the implementation (verified against the same
    dynamics in the spatial-domain oracle).  What must hold at any size:
    iterates respect the projection boxes, σ² moves toward truth, θ stays
    in band, and the trajectory is finite/reproducible.
    """
    import dataclasses as dc

    from semiblind_tv.models import ParamSpec
    from semiblind_tv.runtime import build_problem, laplace_preset

    scale = (64 * 64) / (512 * 512)
    cfg = laplace_preset()
    cfg = dc.replace(
        cfg,
        sigma_step_scale=10_000.0 * scale,
        psf_params=(
            ParamSpec("b", init=0.1, box=(1e-3, 1.0), step_scale=100.0 * scale,
                      fix=False, true_value=0.3),
        ),
        sapg=dc.replace(cfg.sapg, samples=4_000, warmup=2_000, burn_in=3_200),
    )
    problem = build_problem(synthetic_wheel(64), cfg, jax.random.key(21), dtype=jnp.float32)
    res = run_sapg(problem, jax.random.key(22))
    bs = res.psf_param_traces["b"]
    assert np.all(bs >= 1e-3 - 1e-9) and np.all(bs <= 1.0 + 1e-9)
    assert np.all(np.isfinite(res.logPiTrace))
    sigma2_true = float(problem.sigma_true) ** 2
    assert abs(np.log(res.sigma2_EB) - np.log(sigma2_true)) < abs(
        np.log(float(problem.sigma2_init)) - np.log(sigma2_true)
    )
    assert 1e-3 <= res.theta_EB <= 1.0


def test_gaussian_dynamics_oracle_smoke():
    """The Gaussian family of the dynamics simulator (run_Gaussian_demo.m
    constants, w1/w2 free): finite trajectories, box-respecting iterates,
    σ² moving toward truth from the BSNR-midpoint init."""
    from tests import oracles

    x = np.asarray(synthetic_wheel(48), dtype=np.float64)
    res = oracles.np_sapg_dynamics_run(x, "gaussian", seed=7, samples=200, warmup=100)
    for p in ("w1", "w2"):
        tr = res[p + "s"]
        assert np.all(np.isfinite(tr[1:]))
        assert np.all(tr[1:] >= 0.1 - 1e-12) and np.all(tr[1:] <= 1.0 + 1e-12)
    assert np.all(np.isfinite(res["logPiTrace"]))
    assert abs(np.log(res["sigma2_EB"] / res["sigma2_true"])) < abs(
        np.log(res["sigma2_init"] / res["sigma2_true"])
    )

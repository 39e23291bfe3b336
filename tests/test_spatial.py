"""Spatial (row-block) sharding vs the single-device reference ops.

Runs on the 8-device virtual CPU mesh (conftest).  Every spatial primitive
must reproduce its single-device twin on the GLOBAL image to f64 accuracy:
halo-exchanged stencils ≡ ops/tv stencils, reduce-scattered matmul-DFTs ≡
ops/fourier matmul-DFTs, and the composed spatially-sharded SALSA ≡
solvers.salsa.salsa_tv.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from semiblind_tv.ops import fourier
from semiblind_tv.ops.psf import gaussian_kernel
from semiblind_tv.ops.tv import chambolle_prox, divergence, forward_gradient, tv_norm
from semiblind_tv.parallel.mesh import SPACE_AXIS, make_spatial_mesh
from semiblind_tv.parallel import spatial

M = N = 64
DTYPE = jnp.float64


@pytest.fixture(scope="module")
def mesh():
    return make_spatial_mesh(8)


@pytest.fixture(scope="module")
def img():
    return jax.random.uniform(jax.random.key(0), (M, N), DTYPE) * 255.0


def _smap(mesh, fn, n_in, out_spec):
    ax = mesh.axis_names[0]
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=(P(ax, None),) * n_in, out_specs=out_spec
        )
    )


def test_spatial_tv_norm(mesh, img):
    got = _smap(mesh, lambda x: spatial.spatial_tv_norm(x), 1, P())(img)
    np.testing.assert_allclose(float(got), float(tv_norm(img)), rtol=1e-13)


def test_spatial_stencils(mesh, img):
    p1 = img / 255.0
    p2 = jnp.flipud(img) / 255.0
    ax = mesh.axis_names[0]
    got_div = _smap(
        mesh, lambda a, b: spatial.spatial_divergence(a, b), 2, P(ax, None)
    )(p1, p2)
    np.testing.assert_allclose(np.asarray(got_div), np.asarray(divergence(p1, p2)), atol=1e-14)

    got_gx, got_gy = _smap(
        mesh,
        lambda a: spatial.spatial_forward_gradient(a),
        1,
        (P(ax, None), P(ax, None)),
    )(p1)
    ref_gx, ref_gy = forward_gradient(p1)
    np.testing.assert_allclose(np.asarray(got_gx), np.asarray(ref_gx), atol=1e-14)
    np.testing.assert_allclose(np.asarray(got_gy), np.asarray(ref_gy), atol=1e-14)


def test_spatial_chambolle_prox(mesh, img):
    ax = mesh.axis_names[0]
    lam = 0.05
    f_ref, st_ref = chambolle_prox(img, lam, 25)

    def run(g):
        f, (px, py, k, err) = spatial.spatial_chambolle_prox(g, lam, 25)
        return f, px, py, k, err

    f, px, py, k, err = _smap(
        mesh, run, 1, (P(ax, None), P(ax, None), P(ax, None), P(), P())
    )(img)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-12)
    np.testing.assert_allclose(np.asarray(px), np.asarray(st_ref.px), atol=1e-12)
    assert int(k) == int(st_ref.iters)
    np.testing.assert_allclose(float(err), float(st_ref.err), rtol=1e-10)


def test_spatial_transforms_roundtrip(mesh, img):
    ax = mesh.axis_names[0]
    mats = fourier.rdft_matrices((M, N), DTYPE)
    ref = fourier.rfft2_matmul(img, mats)

    zre, zim = _smap(
        mesh,
        lambda x: spatial.spatial_rfft2(x, mats),
        1,
        (P(ax, None), P(ax, None)),
    )(img)
    np.testing.assert_allclose(np.asarray(zre), np.asarray(ref.real), atol=1e-9)
    np.testing.assert_allclose(np.asarray(zim), np.asarray(ref.imag), atol=1e-9)

    back = jax.jit(
        jax.shard_map(
            lambda a, b: spatial.spatial_irfft2(a, b, mats),
            mesh=mesh,
            in_specs=(P(ax, None), P(ax, None)),
            out_specs=P(ax, None),
        )
    )(zre, zim)
    np.testing.assert_allclose(np.asarray(back), np.asarray(img), atol=1e-9)


def test_spatial_blur_apply(mesh, img):
    ax = mesh.axis_names[0]
    mats = fourier.rdft_matrices((M, N), DTYPE)
    blur = fourier.BlurOperator((M, N), 7, DTYPE, fft_mode="dft")
    k = gaussian_kernel(7, 0.4, 0.3, dtype=DTYPE)
    H = blur.otf_host(k)
    ref = jax.jit(lambda x: blur.apply(x, jnp.asarray(H)))(img)
    ref_t = jax.jit(lambda x: blur.apply_adjoint(x, jnp.asarray(H)))(img)

    Hre = jnp.asarray(H.real, DTYPE)
    Him = jnp.asarray(H.imag, DTYPE)
    run = jax.jit(
        jax.shard_map(
            lambda x, hr, hi: (
                spatial.spatial_blur_apply(x, hr, hi, mats),
                spatial.spatial_blur_apply(x, hr, hi, mats, adjoint=True),
            ),
            mesh=mesh,
            in_specs=(P(ax, None),) * 3,
            out_specs=(P(ax, None), P(ax, None)),
        )
    )
    got, got_t = run(img, Hre, Him)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(ref_t), atol=1e-9)


def test_spatial_myula_step_matches_composition(mesh, img):
    ax = mesh.axis_names[0]
    mats = fourier.rdft_matrices((M, N), DTYPE)
    blur = fourier.BlurOperator((M, N), 7, DTYPE, fft_mode="dft")
    H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=DTYPE))
    y = jax.jit(lambda x: blur.apply(x, jnp.asarray(H)))(img)
    prox = img * 0.9
    z = jax.random.normal(jax.random.key(3), (M, N), DTYPE)
    gamma, lam, sigma2 = 1.5, 2.0, 4.0

    @jax.jit
    def ref_step(x):
        yhat = blur.rfft(y)
        rhat = jnp.asarray(H) * blur.rfft(x) - yhat
        gradF = blur.irfft(jnp.conj(jnp.asarray(H)) * rhat) / sigma2
        return jnp.abs(x + gamma * (prox - x) / lam - gamma * gradF + jnp.sqrt(2 * gamma) * z)

    yh = fourier.rfft2_matmul(y, mats)
    run = jax.jit(
        jax.shard_map(
            lambda x, p, zz, hr, hi, yr, yi: spatial.spatial_myula_step(
                x, p, zz, hr, hi, yr, yi, mats, gamma, lam, sigma2
            ),
            mesh=mesh,
            in_specs=(P(ax, None),) * 7,
            out_specs=P(ax, None),
        )
    )
    got = run(
        img, prox, z,
        jnp.asarray(H.real, DTYPE), jnp.asarray(H.imag, DTYPE),
        jnp.asarray(np.asarray(yh.real)), jnp.asarray(np.asarray(yh.imag)),
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref_step(img)), atol=1e-9)


def test_spatial_salsa_matches_single_device(mesh, img):
    from semiblind_tv.solvers.salsa import salsa_tv

    blur = fourier.BlurOperator((M, N), 7, DTYPE, fft_mode="dft")
    H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=DTYPE))
    key = jax.random.key(9)
    y = jax.jit(lambda x: blur.apply(x, jnp.asarray(H)))(img) + 2.0 * jax.random.normal(
        key, (M, N), DTYPE
    )
    tau, mu = 0.08, 0.008

    ref = salsa_tv(y, H, tau, mu, blur, max_iter=60, tol=1e-5, tv_iters=10)
    x_sp, objs, n_it = spatial.spatial_salsa_tv(
        y, H, tau, mu, mesh, max_iter=60, tol=1e-5, tv_iters=10, dtype=DTYPE
    )
    assert n_it == ref.n_iters
    np.testing.assert_allclose(np.asarray(x_sp), ref.x, atol=1e-10)
    np.testing.assert_allclose(
        objs[: n_it], ref.objective[1 : n_it + 1], rtol=1e-12
    )


def test_spatial_sapg_matches_single_device(mesh):
    """Full spatially-sharded estimator vs run_sapg(n_chains=1): same noise
    sequence (replicated draw + row slice), same math → same trajectory to
    reduction-order rounding at f64."""
    import dataclasses as dc

    from semiblind_tv.runtime import build_problem, gaussian_preset
    from semiblind_tv.sapg import run_sapg
    from semiblind_tv.utils import synthetic_wheel

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dc.replace(
        cfg,
        sapg=dc.replace(
            cfg.sapg, samples=40, warmup=20, burn_in=32, fft_mode="dft"
        ),
    )
    problem = build_problem(synthetic_wheel(M), cfg, jax.random.key(5), dtype=DTYPE)
    key = jax.random.key(6)

    ref = run_sapg(problem, key, n_chains=1)
    got = spatial.run_sapg_spatial(problem, mesh, key)

    np.testing.assert_allclose(got.thetas, ref.thetas, rtol=1e-9)
    np.testing.assert_allclose(got.sigma2s, ref.sigma2s, rtol=1e-9)
    for n in ref.psf_param_traces:
        np.testing.assert_allclose(
            got.psf_param_traces[n], ref.psf_param_traces[n], rtol=1e-9
        )
    np.testing.assert_allclose(got.logPiTrace, ref.logPiTrace, rtol=1e-9)
    np.testing.assert_allclose(
        got.logPiTrace_warmup, ref.logPiTrace_warmup, rtol=1e-9
    )
    np.testing.assert_allclose(got.X_last, ref.X_last, atol=1e-9)
    assert abs(got.theta_EB - ref.theta_EB) < 1e-9


def test_spatial_sapg_checkpoint_resume(mesh, tmp_path):
    """Spatial estimator checkpoint/resume ≡ uninterrupted run (the carry's
    spectrum rides as re/im planes, so nothing complex touches the host)."""
    import dataclasses as dc

    from semiblind_tv.runtime import build_problem, gaussian_preset
    from semiblind_tv.utils import synthetic_wheel

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dc.replace(
        cfg,
        sapg=dc.replace(cfg.sapg, samples=24, warmup=10, burn_in=20, fft_mode="dft"),
    )
    problem = build_problem(synthetic_wheel(M), cfg, jax.random.key(5), dtype=DTYPE)
    key = jax.random.key(6)

    full = spatial.run_sapg_spatial(problem, mesh, key)
    ckpt = str(tmp_path / "spatial.npz")
    seg = spatial.run_sapg_spatial(
        problem, mesh, key, checkpoint_every=7, checkpoint_path=ckpt
    )
    np.testing.assert_allclose(seg.thetas, full.thetas, rtol=1e-12)
    np.testing.assert_allclose(seg.X_last, full.X_last, atol=1e-12)
    # resume with the final checkpoint present reconstructs the full bundle
    resumed = spatial.run_sapg_spatial(
        problem, mesh, key, checkpoint_every=7, checkpoint_path=ckpt
    )
    np.testing.assert_allclose(resumed.thetas, full.thetas, rtol=1e-12)
    np.testing.assert_allclose(
        resumed.logPiTrace_warmup, full.logPiTrace_warmup, rtol=1e-12
    )


def test_spatial_sapg_nan_guard_recovers(mesh, tmp_path):
    """Fail-fast + auto-restore in the spatial estimator: a fault injected
    into the carry mid-run is detected by the NaN guard and the run
    recovers from the last checkpoint to the uninterrupted trajectory."""
    import dataclasses as dc

    from semiblind_tv.runtime import build_problem, gaussian_preset
    from semiblind_tv.utils import synthetic_wheel

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dc.replace(
        cfg,
        sapg=dc.replace(cfg.sapg, samples=24, warmup=6, burn_in=20, fft_mode="dft"),
    )
    problem = build_problem(synthetic_wheel(M), cfg, jax.random.key(5), dtype=DTYPE)
    key = jax.random.key(6)
    full = spatial.run_sapg_spatial(problem, mesh, key)

    hits = {"n": 0}

    def fault(seg_idx, carry):
        if seg_idx == 2 and hits["n"] == 0:
            hits["n"] += 1
            Xl = carry[0] * jnp.nan
            return (Xl,) + carry[1:]
        return carry

    ckpt = str(tmp_path / "spatial_fault.npz")
    res = spatial.run_sapg_spatial(
        problem, mesh, key, checkpoint_every=7, checkpoint_path=ckpt,
        fault_hook=fault, max_restores=1,
    )
    assert hits["n"] == 1
    np.testing.assert_allclose(res.thetas, full.thetas, rtol=1e-12)


def test_space_mesh_cli_flag(tmp_path):
    """`run_demo --space-mesh S` routes the SAPG phase through
    run_sapg_spatial end-to-end (TODO r3: the spatial-mode CLI surface)."""
    from semiblind_tv.cli.run_demo import main

    results = main([
        "--psf", "gaussian", "--image", "synthetic", "--size", "32",
        "--samples", "6", "--warmup", "4", "--space-mesh", "4",
        "--out", str(tmp_path),
    ])
    assert np.isfinite(results["theta_EB"]) and np.isfinite(results["mse_db"])
    assert (tmp_path / "results.json").exists()


def test_space_mesh_cli_flag_raises_when_devices_short():
    """`--space-mesh S` with fewer than S devices fails instead of moving
    the run to a virtual CPU mesh."""
    from semiblind_tv.cli.run_demo import main

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        main(["--psf", "gaussian", "--image", "synthetic", "--size", "32",
              "--samples", "6", "--warmup", "4", "--space-mesh", "16"])

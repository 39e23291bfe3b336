"""TV norm and Chambolle prox vs the NumPy oracle (iteration-for-iteration)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semiblind_tv.ops import tv
from tests import oracles


def test_tv_norm_matches_oracle(rng):
    x = rng.standard_normal((17, 23))
    got = tv.tv_norm(jnp.asarray(x))
    np.testing.assert_allclose(got, oracles.np_tv(x), rtol=1e-12)


def test_divergence_gradient_adjointness(rng):
    """⟨∇u, p⟩ = -⟨u, div p⟩ does NOT hold exactly for the reference's
    stencils (its divergence last-row convention differs from the exact
    adjoint) — instead verify both match the oracle."""
    u = rng.standard_normal((9, 11))
    p1 = rng.standard_normal((9, 11))
    p2 = rng.standard_normal((9, 11))
    np.testing.assert_allclose(
        tv.divergence(jnp.asarray(p1), jnp.asarray(p2)),
        oracles._np_div(p1, p2),
        rtol=1e-12,
    )
    gx, gy = tv.forward_gradient(jnp.asarray(u))
    ox, oy = oracles._np_grad(u)
    np.testing.assert_allclose(gx, ox, rtol=1e-12)
    np.testing.assert_allclose(gy, oy, rtol=1e-12)


@pytest.mark.parametrize("lam,max_iter", [(0.5, 25), (5.0, 10), (0.05, 25)])
def test_chambolle_matches_oracle(rng, lam, max_iter):
    g = 10.0 * rng.standard_normal((24, 24))
    f, st = tv.chambolle_prox(jnp.asarray(g), lam, max_iter)
    of, opx, opy, ok, oerr = oracles.np_chambolle(g, lam, max_iter)
    np.testing.assert_allclose(f, of, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(st.px, opx, rtol=1e-9, atol=1e-10)
    assert int(st.iters) == ok
    np.testing.assert_allclose(float(st.err), oerr, rtol=1e-8)


def test_chambolle_warm_start_matches_oracle(rng):
    g = 5.0 * rng.standard_normal((16, 16))
    _, st1 = tv.chambolle_prox(jnp.asarray(g), 1.0, 10)
    f2, st2 = tv.chambolle_prox(jnp.asarray(g), 1.0, 10, duals=(st1.px, st1.py))
    _, px1, py1, _, _ = oracles.np_chambolle(g, 1.0, 10)
    of2, opx2, _, _, _ = oracles.np_chambolle(g, 1.0, 10, duals=(px1, py1))
    np.testing.assert_allclose(f2, of2, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(st2.px, opx2, rtol=1e-9, atol=1e-10)


def test_chambolle_early_exit(rng):
    g = 0.01 * rng.standard_normal((8, 8))
    _, st = tv.chambolle_prox(jnp.asarray(g), 1.0, 50, tol=1e30)
    assert int(st.iters) == 1  # stops after the mandatory first sweep


def test_chambolle_is_a_prox(rng):
    """prox objective ½||g-f||² + λ TV(f) must not exceed the value at g."""
    g = jnp.asarray(rng.standard_normal((32, 32)) * 3)
    lam = 0.8
    f, _ = tv.chambolle_prox(g, lam, 200)
    obj_f = 0.5 * jnp.sum((g - f) ** 2) + lam * tv.tv_norm(f)
    obj_g = lam * tv.tv_norm(g)
    assert float(obj_f) <= float(obj_g) + 1e-6


def test_chambolle_batched_vmap(rng):
    import jax

    g = rng.standard_normal((3, 12, 12))
    f_b, st_b = jax.vmap(lambda x: tv.chambolle_prox(x, 0.7, 15))(jnp.asarray(g))
    for i in range(3):
        f_i, _ = tv.chambolle_prox(jnp.asarray(g[i]), 0.7, 15)
        np.testing.assert_allclose(f_b[i], f_i, rtol=1e-9, atol=1e-12)


def test_tv_denoise_circular_matches_oracle(rng):
    """Verbatim NumPy port of tvdenoising.m as oracle."""
    from semiblind_tv.ops.tv import tv_denoise_circular

    y = 10 * rng.standard_normal((24, 24))
    lam, niter, tau = 2.0, 30, 0.249
    # oracle
    dh = lambda x: np.roll(x, -1, 1) - x
    dv = lambda x: np.roll(x, -1, 0) - x
    dht = lambda x: np.roll(x, 1, 1) - x
    dvt = lambda x: np.roll(x, 1, 0) - x
    Z1 = np.zeros_like(y); Z2 = np.zeros_like(y)
    for _ in range(niter):
        x = dht(Z1) + dvt(Z2) - y
        W = 1.0 / (1.0 + (2.0 / lam) * tau * np.sqrt(dh(x) ** 2 + dv(x) ** 2))
        Z1 = (Z1 - tau * dh(x)) * W
        Z2 = (Z2 - tau * dv(x)) * W
    want = y - dht(Z1) - dvt(Z2)
    got = tv_denoise_circular(jnp.asarray(y), lam, niter)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    # it actually denoises: TV reduced
    from semiblind_tv.ops.tv import tv_norm
    assert float(tv_norm(jnp.asarray(got))) < float(tv_norm(jnp.asarray(y)))


def test_projk_denoise_runs_and_smooths(rng):
    from semiblind_tv.ops.tv import projk_denoise, tv_norm

    g = 10 * rng.standard_normal((16, 16))
    u = projk_denoise(jnp.asarray(g), 1.5, 40)
    assert np.all(np.isfinite(u))
    assert float(tv_norm(jnp.asarray(u))) < float(tv_norm(jnp.asarray(g)))


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("tol", [1e-3, 0.0], ids=["early_exit", "no_exit"])
def test_chambolle_xla_vs_oracle(rng, warm, tol):
    """The XLA prox against np_chambolle on a non-square field, with fresh or
    warm-started duals, with the residual early exit firing or disabled."""
    g = 3.0 * rng.standard_normal((20, 28))
    lam, max_iter = 0.1, 200
    duals = None
    if warm:
        _, px0, py0, _, _ = oracles.np_chambolle(g, lam, 5)
        duals = (px0, py0)
    f, st = tv.chambolle_prox(
        jnp.asarray(g), lam, max_iter, tol=tol,
        duals=None if duals is None else tuple(jnp.asarray(d) for d in duals),
    )
    of, opx, opy, ok, oerr = oracles.np_chambolle(g, lam, max_iter, tol=tol, duals=duals)
    assert int(st.iters) == ok
    assert (ok < max_iter) == (tol > 0)
    np.testing.assert_allclose(f, of, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(st.px, opx, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(st.py, opy, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(float(st.err), oerr, rtol=1e-8)


@pytest.mark.parametrize("batch", [2, 5])
def test_chambolle_vmapped_batch_vs_oracle(rng, batch):
    """vmapped prox (the SAPG chains): every image keeps its own early exit
    and matches the oracle on its own."""
    g = rng.standard_normal((batch, 16, 16)) * np.linspace(1.0, 10.0, batch)[:, None, None]
    f_b, st_b = jax.vmap(lambda x: tv.chambolle_prox(x, 0.1, 200))(jnp.asarray(g))
    assert len(set(np.asarray(st_b.iters).tolist())) > 1  # exits differ per image
    for i in range(batch):
        of, opx, opy, ok, _ = oracles.np_chambolle(g[i], 0.1, 200)
        assert int(st_b.iters[i]) == ok
        np.testing.assert_allclose(f_b[i], of, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(st_b.px[i], opx, rtol=1e-9, atol=1e-10)

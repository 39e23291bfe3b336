"""SALSA ADMM solver vs the NumPy oracle, trajectory-for-trajectory."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from semiblind_tv.solvers import salsa_tv, soft_threshold
from tests import oracles

SHAPE = (32, 32)


def _make_problem(rng):
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = blur.otf(k)
    x = np.kron(rng.random((8, 8)) * 100, np.ones((4, 4)))  # piecewise constant
    y = oracles.np_blur(x, oracles.np_otf(np.asarray(k), SHAPE))
    y = y + 0.5 * rng.standard_normal(SHAPE)
    return blur, H, x, y


def test_salsa_matches_oracle(rng):
    blur, H, x, y = _make_problem(rng)
    tau, mu = 0.15, 0.015
    res = salsa_tv(
        jnp.asarray(y), H, tau, mu, blur, max_iter=25, tol=1e-12, tv_iters=10,
        x_true=jnp.asarray(x),
    )
    H_full = oracles.np_otf(
        np.asarray(psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)), SHAPE
    )
    want = oracles.np_salsa(
        y, H_full, tau, mu, max_iter=25, tol=1e-12, tv_iters=10, x_true=x,
    )
    np.testing.assert_allclose(res.x, want["x"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res.objective, want["objective"], rtol=1e-8)
    np.testing.assert_allclose(res.mses, want["mses"], rtol=1e-7)
    np.testing.assert_allclose(res.distance[: want["n_iters"]], want["distance"], rtol=1e-6)
    assert res.n_iters == want["n_iters"]


def test_salsa_early_stop(rng):
    blur, H, x, y = _make_problem(rng)
    res = salsa_tv(jnp.asarray(y), H, 0.15, 0.015, blur, max_iter=300, tol=1e-4)
    want = oracles.np_salsa(
        y,
        oracles.np_otf(np.asarray(psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)), SHAPE),
        0.15, 0.015, max_iter=300, tol=1e-4,
    )
    assert res.n_iters == want["n_iters"]
    assert res.n_iters < 300
    np.testing.assert_allclose(res.x, want["x"], rtol=1e-7, atol=1e-8)


def test_salsa_improves_mse(rng):
    blur, H, x, y = _make_problem(rng)
    res = salsa_tv(jnp.asarray(y), H, 0.15, 0.015, blur, max_iter=200, tol=1e-6)
    mse_y = np.mean((y - x) ** 2)
    mse_map = np.mean((res.x - x) ** 2)
    assert mse_map < 0.5 * mse_y


def test_soft_threshold():
    x = jnp.asarray([-2.0, -0.5, 0.0, 0.5, 2.0])
    got = soft_threshold(x, 1.0)
    # max(|x|-T,0)/(max(|x|-T,0)+T) * x — the reference's scaled shrinkage
    y = np.maximum(np.abs(np.asarray(x)) - 1.0, 0)
    want = y / (y + 1.0) * np.asarray(x)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(soft_threshold(x, 0.0), x)

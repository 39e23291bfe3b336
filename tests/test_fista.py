"""FISTA solver vs a NumPy oracle and improvement sanity checks."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from semiblind_tv.solvers import fista_tv
from tests import oracles

SHAPE = (32, 32)


def _np_fista_tv(b, H, tau, L, tv_iters, max_iter, tol):
    """Oracle: my_deblur_fista.m loop in NumPy."""
    A = lambda v: oracles.np_blur(v, H)
    AT = lambda v: oracles.np_blur_adj(v, H)
    x = np.zeros_like(b)
    yk = x.copy()
    t = 1.0
    objective = [0.5 * np.sum((A(x) - b) ** 2) + tau * oracles.np_tv(x)]
    # MATLAB `for k = 2:maxiters` runs maxiters-1 iterations; our solver's
    # max_iter counts iterations, so run max_iter of them here.
    for k in range(2, max_iter + 2):
        x_old = x
        t_old = t
        yk = yk - (1.0 / L) * AT(A(yk) - b)
        x, _, _, _, _ = oracles.np_chambolle(yk, tau / L, tv_iters)
        t = 0.5 * (1 + np.sqrt(1 + 4 * t_old**2))
        yk = x + ((t_old - 1) / t) * (x - x_old)
        objective.append(0.5 * np.sum((A(x) - b) ** 2) + tau * oracles.np_tv(x))
        crit = abs(objective[-1] - objective[-2]) / objective[-1]
        if crit < tol:
            break
    return x, np.array(objective)


def _problem(rng):
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = blur.otf(k)
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    x = np.kron(rng.random((8, 8)) * 50, np.ones((4, 4)))
    y = oracles.np_blur(x, H_full) + 0.3 * rng.standard_normal(SHAPE)
    return blur, H, H_full, x, y


def test_fista_tv_matches_oracle(rng):
    blur, H, H_full, x, y = _problem(rng)
    res = fista_tv(jnp.asarray(y), H, tau=0.2, blur=blur, tv_iters=10,
                   max_iter=40, tol=1e-12)
    ox, oobj = _np_fista_tv(y, H_full, 0.2, 1.0, 10, 40, 1e-12)
    np.testing.assert_allclose(res.x, ox, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res.objective, oobj, rtol=1e-8)


def test_fista_early_stop_and_improvement(rng):
    blur, H, H_full, x, y = _problem(rng)
    res = fista_tv(jnp.asarray(y), H, tau=0.2, blur=blur, max_iter=300,
                   tol=1e-6, x_true=jnp.asarray(x))
    ox, oobj = _np_fista_tv(y, H_full, 0.2, 1.0, 10, 300, 1e-6)
    assert res.n_iters == len(oobj) - 1
    assert res.n_iters < 300
    assert res.mses[res.n_iters] < res.mses[0]

"""Power iteration vs the closed-form max|H|²."""
import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, lipschitz, psf


def test_power_iteration_matches_closed_form():
    shape = (32, 32)
    blur = fourier.BlurOperator(shape, 7, jnp.float64)
    k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = blur.otf(k)

    closed = lipschitz.max_eigenval_closed_form(H)

    def AtA(x):
        return blur.apply_adjoint(blur.apply(x, H), H)

    val, iters = lipschitz.power_iteration(AtA, jax.random.key(0), shape, tol=1e-7)
    np.testing.assert_allclose(float(val), float(closed), rtol=1e-4)
    assert int(iters) > 1

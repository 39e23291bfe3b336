"""PSF kernels and analytic gradients vs NumPy oracles, autodiff, and FD."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semiblind_tv.ops import psf
from tests import oracles


SIZE = 7


def test_gaussian_matches_oracle():
    k = psf.gaussian_kernel(SIZE, 0.4, 0.3, 0.7, dtype=jnp.float64)
    np.testing.assert_allclose(k, oracles.np_gaussian_kernel(SIZE, 0.4, 0.3, 0.7), rtol=1e-12)
    assert np.isclose(float(jnp.sum(k)), 1.0)


def test_laplace_matches_oracle():
    k = psf.laplace_kernel(SIZE, 0.3, dtype=jnp.float64)
    np.testing.assert_allclose(k, oracles.np_laplace_kernel(SIZE, 0.3), rtol=1e-12)


def test_moffat_matches_oracle():
    k = psf.moffat_kernel(SIZE, 0.4, 3.5, dtype=jnp.float64)
    np.testing.assert_allclose(k, oracles.np_moffat_kernel(SIZE, 0.4, 3.5), rtol=1e-12)


@pytest.mark.parametrize("w1,w2,phi", [(0.4, 0.3, 0.0), (0.7, 0.2, 0.5)])
def test_gaussian_grads_vs_autodiff(w1, w2, phi):
    _, dk1, dk2 = psf.gaussian_kernel_grads(SIZE, w1, w2, phi, dtype=jnp.float64)
    jac1 = jax.jacfwd(lambda a: psf.gaussian_kernel(SIZE, a, w2, phi, jnp.float64))(
        jnp.float64(w1)
    )
    jac2 = jax.jacfwd(lambda b: psf.gaussian_kernel(SIZE, w1, b, phi, jnp.float64))(
        jnp.float64(w2)
    )
    np.testing.assert_allclose(dk1, jac1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dk2, jac2, rtol=1e-9, atol=1e-12)


def test_laplace_grad_vs_autodiff():
    _, db = psf.laplace_kernel_grads(SIZE, 0.3, dtype=jnp.float64)
    jac = jax.jacfwd(lambda b: psf.laplace_kernel(SIZE, b, jnp.float64))(jnp.float64(0.3))
    np.testing.assert_allclose(db, jac, rtol=1e-9, atol=1e-12)


def test_moffat_beta_grad_vs_autodiff():
    a, b = 0.4, 3.5
    _, _, db = psf.moffat_kernel_grads(SIZE, a, b, dtype=jnp.float64)
    jacb = jax.jacfwd(lambda p: psf.moffat_kernel(SIZE, a, p, jnp.float64))(jnp.float64(b))
    np.testing.assert_allclose(db, jacb, rtol=1e-9, atol=1e-12)


def test_moffat_alpha_grad_matches_reference_formula():
    """The reference's alpha partial is NOT the exact derivative (factor 2 in
    the second term's denominator — diff_moffat_alpha.m:17); we reproduce its
    formula verbatim.  Check against an independent NumPy evaluation of it."""
    a, b = 0.4, 3.5
    _, da, _ = psf.moffat_kernel_grads(SIZE, a, b, dtype=jnp.float64)
    v, u = oracles.grid(SIZE)
    r2 = v**2 + u**2
    pw = (r2 * a**2 / b + 1) ** (-(b + 2) / 2)
    f = a**2 * pw / (2 * np.pi)
    dref = (2 - ((b + 2) * r2 * a**2) / (2 * (b + r2 * a**2))) * pw * (a / (2 * np.pi))
    S, Sd = f.sum(), dref.sum()
    want = (dref * S - f * Sd) / S**2
    np.testing.assert_allclose(da, want, rtol=1e-10)
    # and confirm it is NOT the exact derivative (the quirk is real)
    jaca = jax.jacfwd(lambda p: psf.moffat_kernel(SIZE, p, b, jnp.float64))(jnp.float64(a))
    assert not np.allclose(da, jaca, rtol=1e-3)


def test_gaussian_grads_vs_finite_difference():
    w1, w2, eps = 0.4, 0.3, 1e-6
    _, dk1, _ = psf.gaussian_kernel_grads(SIZE, w1, w2, 0.0, dtype=jnp.float64)
    fd = (
        oracles.np_gaussian_kernel(SIZE, w1 + eps, w2)
        - oracles.np_gaussian_kernel(SIZE, w1 - eps, w2)
    ) / (2 * eps)
    np.testing.assert_allclose(dk1, fd, rtol=1e-5, atol=1e-9)

"""Spatial circular conv ≡ the corner-padded-OTF Fourier operator."""
import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from semiblind_tv.ops.spatial_conv import circ_conv, circ_corr

SHAPE = (32, 24)


def _blur_and_kernel(rng, family="gaussian"):
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    if family == "gaussian":
        k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    elif family == "laplace":
        k = psf.laplace_kernel(7, 0.3, dtype=jnp.float64)
    else:
        k = psf.moffat_kernel(7, 0.4, 3.5, dtype=jnp.float64)
    return blur, k


def test_circ_conv_matches_fourier_apply(rng):
    for family in ("gaussian", "laplace", "moffat"):
        blur, k = _blur_and_kernel(rng, family)
        H = blur.otf(k)
        x = jnp.asarray(rng.standard_normal(SHAPE))
        np.testing.assert_allclose(
            np.asarray(circ_conv(x, k)),
            np.asarray(blur.apply(x, H)),
            rtol=1e-12, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(circ_corr(x, k)),
            np.asarray(blur.apply_adjoint(x, H)),
            rtol=1e-12, atol=1e-12,
        )


def test_circ_conv_batched_and_adjointness(rng):
    blur, k = _blur_and_kernel(rng)
    xb = jnp.asarray(rng.standard_normal((3,) + SHAPE))
    H = blur.otf(k)
    got = circ_conv(xb, k)
    assert got.shape == xb.shape
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(got[i]), np.asarray(blur.apply(xb[i], H)),
            rtol=1e-12, atol=1e-12,
        )
    # <Ax, y> == <x, A^T y> (true adjoint pair)
    y = jnp.asarray(rng.standard_normal(SHAPE))
    x = xb[0]
    lhs = float(jnp.sum(circ_conv(x, k) * y))
    rhs = float(jnp.sum(x * circ_corr(y, k)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_circ_conv_translation_quirk_preserved(rng):
    """The corner-pad embedding's (s−1)/2 translation (utils/resize.m:8 — no
    ifftshift) must survive: a delta kernel at the PSF center translates the
    image, exactly as the Fourier path does."""
    blur, _ = _blur_and_kernel(rng)
    k = jnp.zeros((7, 7), jnp.float64).at[3, 3].set(1.0)
    x = jnp.asarray(rng.standard_normal(SHAPE))
    got = np.asarray(circ_conv(x, k))
    np.testing.assert_allclose(got, np.roll(np.asarray(x), (3, 3), (0, 1)),
                               atol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(blur.apply(x, blur.otf(k))), atol=1e-12)

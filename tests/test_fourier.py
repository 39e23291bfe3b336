"""Blur operator: matmul-OTF vs FFT, Parseval identities, adjointness."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from tests import oracles

SHAPE = (32, 48)


def _setup(dtype=jnp.float64):
    k = psf.gaussian_kernel(7, 0.4, 0.3, 0.0, dtype=dtype)
    blur = fourier.BlurOperator(SHAPE, 7, dtype)
    return k, blur


def test_otf_rfft_matches_padded_fft2():
    k, blur = _setup()
    H = blur.otf(k)
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    np.testing.assert_allclose(H, H_full[:, : SHAPE[1] // 2 + 1], rtol=1e-10, atol=1e-12)


def test_otf_fft_matches_oracle():
    k, _ = _setup()
    H = fourier.otf_fft(k, SHAPE)
    np.testing.assert_allclose(H, oracles.np_otf(np.asarray(k), SHAPE), rtol=1e-10, atol=1e-12)


def test_blur_apply_matches_full_spectrum(rng):
    k, blur = _setup()
    x = rng.standard_normal(SHAPE)
    H = blur.otf(k)
    got = blur.apply(jnp.asarray(x), H)
    want = oracles.np_blur(x, oracles.np_otf(np.asarray(k), SHAPE))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_adjoint_identity(rng):
    k, blur = _setup()
    H = blur.otf(k)
    x = jnp.asarray(rng.standard_normal(SHAPE))
    y = jnp.asarray(rng.standard_normal(SHAPE))
    lhs = jnp.sum(blur.apply(x, H) * y)
    rhs = jnp.sum(x * blur.apply_adjoint(y, H))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_parseval_dot_and_norm(rng):
    _, blur = _setup()
    a = rng.standard_normal(SHAPE)
    b = rng.standard_normal(SHAPE)
    ahat = jnp.fft.rfft2(jnp.asarray(a))
    bhat = jnp.fft.rfft2(jnp.asarray(b))
    d = SHAPE[0] * SHAPE[1]
    got_dot = fourier.parseval_dot(ahat, bhat, blur.weights, d)
    got_norm = fourier.parseval_norm_sq(ahat, blur.weights, d)
    np.testing.assert_allclose(got_dot, np.sum(a * b), rtol=1e-10)
    np.testing.assert_allclose(got_norm, np.sum(a * a), rtol=1e-10)


def test_parseval_odd_width(rng):
    shape = (16, 21)
    blur = fourier.BlurOperator(shape, 5, jnp.float64)
    a = rng.standard_normal(shape)
    ahat = jnp.fft.rfft2(jnp.asarray(a))
    got = fourier.parseval_norm_sq(ahat, blur.weights, shape[0] * shape[1])
    np.testing.assert_allclose(got, np.sum(a * a), rtol=1e-10)


def test_rfft2_matmul_matches_fft(rng):
    for shape in [SHAPE, (16, 21), (8, 8)]:
        mats = fourier.rdft_matrices(shape, jnp.float64)
        x = rng.standard_normal(shape)
        got = fourier.rfft2_matmul(jnp.asarray(x), mats)
        want = np.fft.rfft2(x)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
        # batched
        xb = rng.standard_normal((3,) + shape)
        gotb = fourier.rfft2_matmul(jnp.asarray(xb), mats)
        np.testing.assert_allclose(gotb, np.fft.rfft2(xb, axes=(-2, -1)),
                                   rtol=1e-10, atol=1e-10)


def test_irfft2_matmul_matches_fft(rng):
    for shape in [SHAPE, (16, 21), (8, 8)]:
        mats = fourier.rdft_matrices(shape, jnp.float64)
        zhat = np.fft.rfft2(rng.standard_normal(shape))
        got = fourier.irfft2_matmul(jnp.asarray(zhat), mats)
        want = np.fft.irfft2(zhat, s=shape)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        # general (non-hermitian-consistent) half-spectrum input must also
        # agree — the hot loop feeds conj(H)*Rhat, not an exact rfft2 output
        zb = (rng.standard_normal((2,) + (shape[0], shape[1] // 2 + 1))
              + 1j * rng.standard_normal((2,) + (shape[0], shape[1] // 2 + 1)))
        gotb = fourier.irfft2_matmul(jnp.asarray(zb), mats)
        # oracle: embed into a full hermitian-symmetrized spectrum the way
        # np.fft.irfft2 interprets a half-spectrum
        wantb = np.fft.irfft2(zb, s=shape)
        np.testing.assert_allclose(gotb, wantb, rtol=1e-9, atol=1e-11)


def test_blur_operator_dft_mode_roundtrip(rng):
    k = psf.gaussian_kernel(7, 0.4, 0.3, 0.0, dtype=jnp.float64)
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64, fft_mode="dft")
    H = blur.otf(k)
    x = jnp.asarray(rng.standard_normal(SHAPE))
    want = oracles.np_blur(np.asarray(x), oracles.np_otf(np.asarray(k), SHAPE))
    np.testing.assert_allclose(blur.apply(x, H), want, rtol=1e-9, atol=1e-10)


def test_corner_pad_translation():
    """The reference's corner-pad (no centering) shifts the image by the
    kernel centroid — reproduce: delta kernel at centre of a 7x7 support
    shifts by (3, 3) (utils/resize.m:8)."""
    k = jnp.zeros((7, 7), jnp.float64).at[3, 3].set(1.0)
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    H = blur.otf(k)
    x = jnp.zeros(SHAPE, jnp.float64).at[10, 10].set(1.0)
    out = blur.apply(x, H)
    assert np.argmax(np.asarray(out)) == np.ravel_multi_index((13, 13), SHAPE)

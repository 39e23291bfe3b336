"""Metric functions vs direct NumPy evaluation / known identities."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv import metrics


def test_mse_db(rng):
    x = rng.standard_normal((16, 16))
    y = rng.standard_normal((16, 16))
    want = 10 * np.log10(np.sum((x - y) ** 2) / x.size)
    np.testing.assert_allclose(metrics.mse_db(jnp.asarray(x), jnp.asarray(y)), want, rtol=1e-10)


def test_psnr(rng):
    x = np.abs(rng.standard_normal((8, 8))) + 0.1
    y = x + 0.01 * rng.standard_normal((8, 8))
    want = 10 * np.log10(x.max() ** 2) - 10 * np.log10(np.sum((x - y) ** 2) / x.size)
    np.testing.assert_allclose(metrics.psnr(jnp.asarray(x), jnp.asarray(y)), want, rtol=1e-9)


def test_snr(rng):
    x = rng.standard_normal((8, 8))
    y = x + 0.1 * rng.standard_normal((8, 8))
    want = 20 * np.log10(np.linalg.norm(x) / np.linalg.norm(x - y))
    np.testing.assert_allclose(metrics.snr(jnp.asarray(x), jnp.asarray(y)), want, rtol=1e-9)


def test_l2_spectral(rng):
    x = rng.standard_normal((7, 7))
    y = rng.standard_normal((7, 7))
    want = np.linalg.norm(x - y, ord=2) ** 2  # MATLAB norm(matrix)^2
    np.testing.assert_allclose(metrics.l2_spectral_sq(jnp.asarray(x), jnp.asarray(y)), want, rtol=1e-9)


def test_ssim_identity(rng):
    x = jnp.asarray(rng.standard_normal((64, 64)))
    assert float(metrics.ssim(x, x)) > 0.9999


def test_ssim_degrades(rng):
    x = jnp.asarray(np.abs(rng.standard_normal((64, 64))))
    y = x + 0.5 * jnp.asarray(rng.standard_normal((64, 64)))
    assert float(metrics.ssim(x, y)) < float(metrics.ssim(x, x))


def test_ssim_vs_independent_oracle(rng):
    """SSIM vs a from-scratch NumPy implementation (11x11 gaussian window,
    sigma 1.5, replicate padding, L configurable)."""
    from scipy.ndimage import correlate

    x = np.abs(rng.standard_normal((48, 48))) * 4
    y = x + 0.3 * rng.standard_normal((48, 48))
    L, k1, k2 = 1.0, 0.01, 0.03
    offs = np.arange(11) - 5.0
    g1 = np.exp(-offs**2 / (2 * 1.5**2))
    win = np.outer(g1, g1); win /= win.sum()
    f = lambda im: correlate(im, win, mode="nearest")
    mx, my = f(x), f(y)
    sx = f(x * x) - mx * mx
    sy = f(y * y) - my * my
    sxy = f(x * y) - mx * my
    c1, c2 = (k1 * L) ** 2, (k2 * L) ** 2
    want = np.mean(((2 * mx * my + c1) * (2 * sxy + c2)) /
                   ((mx**2 + my**2 + c1) * (sx + sy + c2)))
    got = float(metrics.ssim(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

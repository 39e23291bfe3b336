"""Wavelet-synthesis L1 SAPG + SALSA experiment (SIAM 4.2.3 capability)."""
import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.sapg.wavelet_l1 import WaveletL1Config, run_sapg_wavelet_l1
from semiblind_tv.utils import synthetic_wheel


def test_wavelet_l1_end_to_end():
    cfg = WaveletL1Config(samples=80, burn_in=20, levels=2, blur_length=5,
                          salsa_iters=120, salsa_tol=1e-6)
    x = synthetic_wheel(32)
    res = run_sapg_wavelet_l1(x, cfg, jax.random.key(0), dtype=jnp.float64)
    assert np.isfinite(res.theta_EB)
    assert cfg.min_th <= res.theta_EB <= cfg.max_th
    assert res.x_map.shape == (32, 32)
    assert np.all(np.isfinite(res.x_map))
    assert np.isfinite(res.mse_db)
    # geometric-mean EB in eta space
    w = res.thetas[cfg.burn_in - 1:]
    np.testing.assert_allclose(res.theta_EB, np.exp(np.mean(np.log(w))), rtol=1e-10)


def test_wavelet_l1_salsa_improves():
    """The MAP solve should beat the blurred observation."""
    cfg = WaveletL1Config(samples=200, burn_in=50, levels=3, blur_length=7,
                          salsa_iters=200, salsa_tol=1e-8)
    x = synthetic_wheel(48)
    res = run_sapg_wavelet_l1(x, cfg, jax.random.key(1), dtype=jnp.float64)
    # recompute observation mse for comparison
    from semiblind_tv.ops.wavelet import uniform_blur_kernel

    k = uniform_blur_kernel(48, 7)
    y = np.real(np.fft.ifft2(np.fft.fft2(k) * np.fft.fft2(x)))
    mse_obs = 10 * np.log10(np.sum((x - y) ** 2) / x.size)
    assert res.mse_db < mse_obs

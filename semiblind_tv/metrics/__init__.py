from semiblind_tv.metrics.metrics import (  # noqa: F401
    mse_db,
    psnr,
    snr,
    l2_spectral_sq,
    ssim,
)

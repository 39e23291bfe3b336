"""semiblind_tv — accelerator-native semi-blind image deblurring with TV priors.

A ground-up JAX/XLA re-design of the capabilities of the reference
MATLAB codebase `charles-kmc/Semi-blind-image-deblurring-problems-with-TV`
(empirical-Bayesian semi-blind deconvolution, arXiv:2403.04536):

  * SAPG (stochastic approximation proximal gradient) estimation of the TV
    weight theta, noise variance sigma^2, and parametric PSF parameters
    (Gaussian w1/w2, Laplace b, Moffat alpha/beta) — reference
    `SAPG/SAPG_algorithm_*.m`.
  * MYULA (Moreau–Yosida unadjusted Langevin) posterior sampling —
    reference `SALSA/myula.m` and the inlined loops in `SAPG/*.m`.
  * Chambolle dual-projection TV proximal operator — reference
    `utils/chambolle_prox_TV_stop.m`.
  * SALSA (ADMM) MAP solver — reference `SALSA/SALSA_v2.m`.

Everything is re-designed for the accelerator: rFFT-diagonal blur operators with
matmul-computed OTFs, a single fused lax.scan per SAPG run (1 rfft + 1
irfft per iteration), vmapped chains, and shard_map parallelism over a
('data', 'chains') device mesh.
"""

__version__ = "0.1.0"

from semiblind_tv.runtime.config import (  # noqa: F401
    SAPGConfig,
    SALSAConfig,
    DemoConfig,
    gaussian_preset,
    laplace_preset,
    moffat_preset,
)

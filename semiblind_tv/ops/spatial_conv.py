"""Spatial-domain circular convolution — the FLOP-minimal A/Aᵀ for small PSFs.

The reference applies the blur in the Fourier domain (run_Gaussian_demo.m:
136-137: A = real(ifft2(H_FFT .* fft2(x)))) because that is what MATLAB
makes fast.  The rfft-as-matmul transform pair costs ~1.6 GFLOP per
512² apply-pair, while the PSF is only 7×7: the SAME operator as a spatial
circular convolution costs 49 MACs/pixel ≈ 26 MFLOP — a ~60× FLOP
reduction.  These kernels are exactly equivalent
to the corner-padded-OTF Fourier path (utils/resize.m:6-11 places the
kernel at the top-left corner with no centering, which IS plain circular
convolution with kernel index (0,0) at the origin):

    (A x)[i,j]  = Σ_{a,b} k[a,b] · x[(i−a) mod M, (j−b) mod N]
    (Aᵀ x)[i,j] = Σ_{a,b} k[a,b] · x[(i+a) mod M, (j+b) mod N]

Implemented as wrap-padding + a VALID XLA convolution.  Equivalence with ops.fourier.BlurOperator is tested at
f64 (tests/test_spatial_conv.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["circ_conv", "circ_corr"]


def _conv_valid(xp: jnp.ndarray, k: jnp.ndarray, precision) -> jnp.ndarray:
    """VALID cross-correlation of (B, Mp, Np) with (s, s)."""
    out = lax.conv_general_dilated(
        xp[:, None],
        k[None, None].astype(xp.dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=precision,
    )
    return out[:, 0]


def circ_conv(x: jnp.ndarray, k: jnp.ndarray,
              precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Circular convolution ≡ BlurOperator.apply(x, otf(k)).

    x: (M, N) or (B, M, N); k: (s, s) with s odd or even (any s ≤ min(M,N)).
    """
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    p = k.shape[-1] - 1
    xp = jnp.concatenate([x[:, -p:, :], x], axis=1) if p else x
    xp = jnp.concatenate([xp[:, :, -p:], xp], axis=2) if p else xp
    out = _conv_valid(xp, k[::-1, ::-1], precision)
    return out[0] if squeeze else out


def circ_corr(x: jnp.ndarray, k: jnp.ndarray,
              precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Circular correlation ≡ BlurOperator.apply_adjoint(x, otf(k))."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    p = k.shape[-1] - 1
    xp = jnp.concatenate([x, x[:, :p, :]], axis=1) if p else x
    xp = jnp.concatenate([xp, xp[:, :, :p]], axis=2) if p else xp
    out = _conv_valid(xp, k, precision)
    return out[0] if squeeze else out

"""Fourier-domain circular blur operator.

The reference embeds the s x s PSF into the *top-left corner* of an
image-sized array and takes fft2 (`utils/resize.m:1-12` — note: no circular
centering, so the blur carries a (s-1)/2-pixel translation; we reproduce this
exactly for parity), then applies the blur as an FFT-diagonal multiply
(`run_Gaussian_demo.m:136-137`).

Redesign decisions:

  * Real-input images ⇒ we work on the rfft2 half-spectrum grid
    (shape (M, N//2 + 1)) — half the transform cost and memory of the
    reference's complex fft2.
  * The PSF changes every SAPG iteration (its parameters are being
    estimated), so the OTF must be recomputed per step.  Instead of padding
    to (M, N) and running a full FFT over mostly-zeros, we evaluate the DFT
    of the s x s kernel directly with two tiny complex matmuls
    (s x M and s x (N//2+1) Fourier factor matrices): H = Fx^T K Fy.
    This is exact, O(s·M·N/2) work, and runs as matmuls.
  * Inner products that the reference computes in the spatial domain after
    extra inverse FFTs (`run_Gaussian_demo.m:173-175`) are evaluated with
    Parseval's theorem on the half-spectrum (`parseval_dot`), eliminating
    those FFTs entirely.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "otf_fft",
    "otf_rfft",
    "dft_factors",
    "rfft_weights",
    "parseval_dot",
    "parseval_norm_sq",
    "rdft_matrices",
    "rfft2_matmul",
    "irfft2_matmul",
    "BlurOperator",
]


def otf_fft(kernel: jnp.ndarray, shape) -> jnp.ndarray:
    """Full-spectrum OTF via corner-pad + fft2 (parity path with resize.m)."""
    M, N = shape
    s = kernel.shape[0]
    padded = jnp.zeros((M, N), kernel.dtype).at[:s, :s].set(kernel)
    return jnp.fft.fft2(padded)


def dft_factors(size: int, shape, dtype=jnp.complex64):
    """Fourier factor matrices (Fx, Fy) for the corner-embedded DFT.

    Fx[i, m] = exp(-2πi·i·m / M) for i in [0, s), m in [0, M)
    Fy[j, n] = exp(-2πi·j·n / N) for j in [0, s), n in [0, N//2]  (rfft cols)

    Built host-side in NumPy (f64 phase accumulation, then cast): they are
    compile-time constants.
    """
    import numpy as np

    M, N = shape
    i = np.arange(size)
    ang_x = (-2.0 * np.pi / M) * np.outer(i, np.arange(M))
    ang_y = (-2.0 * np.pi / N) * np.outer(i, np.arange(N // 2 + 1))
    np_dtype = np.complex128 if dtype == jnp.complex128 else np.complex64
    # Stay as host numpy arrays: jit embeds them as constants directly.
    Fx = np.exp(1j * ang_x).astype(np_dtype)
    Fy = np.exp(1j * ang_y).astype(np_dtype)
    return Fx, Fy


def otf_rfft(kernel: jnp.ndarray, shape, factors=None) -> jnp.ndarray:
    """Half-spectrum OTF of the corner-embedded kernel via two small matmuls.

    Exactly equals otf_fft(kernel, shape)[:, : N//2 + 1].
    """
    s = kernel.shape[0]
    if factors is None:
        factors = dft_factors(s, shape)
    Fx, Fy = factors
    k = kernel.astype(jnp.asarray(Fx).dtype)
    # (M, s) @ (s, s) @ (s, N//2+1) -> (M, N//2+1).  HIGHEST precision: these
    # matmuls are tiny but the OTF feeds every gradient — a reduced-precision
    # matmul (TF32 on the GPU) would inject ~1e-3 relative error into H.
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(Fx.T, k, precision=hp), Fy, precision=hp)


def rfft_weights(shape, dtype=jnp.float32) -> jnp.ndarray:
    """Multiplicity weights of rfft2 columns for full-spectrum sums.

    Column n of the half-spectrum represents one full-spectrum column for
    n == 0 and (if N even) n == N/2, and two (conjugate pair) otherwise.
    """
    _, N = shape
    ncols = N // 2 + 1
    w = 2.0 * jnp.ones((ncols,), dtype)
    w = w.at[0].set(1.0)
    if N % 2 == 0:
        w = w.at[-1].set(1.0)
    return w[None, :]


def parseval_dot(ahat, bhat, weights, dim):
    """sum(a * b) over the spatial domain, for real a, b given on the rfft grid.

    sum_{x} a(x) b(x) = (1/MN) * sum_{full spectrum} ahat * conj(bhat)  (real part)
    """
    return jnp.sum(weights * (ahat * jnp.conj(bhat)).real) / dim


def parseval_norm_sq(ahat, weights, dim):
    """||a||_F^2 for a real field given on the rfft grid."""
    re, im = ahat.real, ahat.imag
    return jnp.sum(weights * (re * re + im * im)) / dim


def rdft_matrices(shape, dtype=jnp.float32):
    """Real cos/sin factor matrices for matmul-based rfft2/irfft2.

    Expressing the per-SAPG-iteration transform pair (irfft2 of the
    gradient, rfft2 of the new sample) as dense DFT matmuls trades
    ~3 GFLOP/chain/iter of matmul work for the FFT launches, and lets the
    row-sharded estimator contract the column transform over a sharded axis
    (parallel/spatial.py).  All matrices are built host-side in f64 and cast
    (compile-time constants).

    Returns a dict of NumPy arrays for shape (M, N), Nh = N//2+1:
      CN, SN   (N, Nh)   cos/sin(2π n k / N)        — forward rows
      CM, SM   (M, M)    cos/sin(2π m k / M)        — forward/inverse cols
                          (symmetric: entries depend only on the product mk)
      WCT, WST (Nh, N)   w_k cos/sin(2π n k / N)/N  — inverse rows, with the
                          rfft column-multiplicity weights w_k and the 1/N
                          normalisation folded in
    """
    import numpy as np

    M, N = shape
    Nh = N // 2 + 1
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    n = np.arange(N)[:, None]
    k = np.arange(Nh)[None, :]
    ang_n = (2.0 * np.pi / N) * (n * k)
    m = np.arange(M)[:, None]
    km = np.arange(M)[None, :]
    ang_m = (2.0 * np.pi / M) * (m * km)
    w = 2.0 * np.ones((Nh, 1))
    w[0, 0] = 1.0
    if N % 2 == 0:
        w[-1, 0] = 1.0
    return dict(
        CN=np.cos(ang_n).astype(np_dtype),
        SN=np.sin(ang_n).astype(np_dtype),
        CM=np.cos(ang_m).astype(np_dtype),
        SM=np.sin(ang_m).astype(np_dtype),
        WCT=(w * np.cos(ang_n).T / N).astype(np_dtype),
        WST=(w * np.sin(ang_n).T / N).astype(np_dtype),
    )


def rfft2_matmul(x, mats, precision=jax.lax.Precision.HIGHEST):
    """rfft2 of real x (..., M, N) via six real matmuls.

    Rows first with factor exp(-2πi nk/N) = CN - i·SN, then columns with the
    symmetric (M, M) factor.  Equals jnp.fft.rfft2 to f32 matmul accuracy
    (~1e-6 relative at 512² with HIGHEST precision — tested).
    """
    CN, SN, CM, SM = mats["CN"], mats["SN"], mats["CM"], mats["SM"]
    yre = jnp.matmul(x, CN, precision=precision)
    yim = -jnp.matmul(x, SN, precision=precision)
    zre = (
        jnp.einsum("km,...mn->...kn", CM, yre, precision=precision)
        + jnp.einsum("km,...mn->...kn", SM, yim, precision=precision)
    )
    zim = (
        jnp.einsum("km,...mn->...kn", CM, yim, precision=precision)
        - jnp.einsum("km,...mn->...kn", SM, yre, precision=precision)
    )
    return jax.lax.complex(zre, zim)


def irfft2_matmul(zhat, mats, precision=jax.lax.Precision.HIGHEST):
    """irfft2 of a half-spectrum (..., M, N//2+1) via six real matmuls.

    Inverse columns with exp(+2πi mk/M) = CM + i·SM (1/M folded in), then
    hermitian-expanded inverse rows: for the conjugate column partner
    k' = N−k, Re[e^{+2πi nk'/N} conj(Y_k)] = Re[e^{−2πi nk/N} (Yre−iYim)] =
    cos·Yre − sin·Yim — identical to the k term, so the full-spectrum sum is
    the weighted half-spectrum sum baked into WCT/WST.
    """
    CM, SM, WCT, WST = mats["CM"], mats["SM"], mats["WCT"], mats["WST"]
    M = CM.shape[0]
    zre, zim = zhat.real, zhat.imag
    yre = (
        jnp.einsum("mk,...kn->...mn", CM, zre, precision=precision)
        - jnp.einsum("mk,...kn->...mn", SM, zim, precision=precision)
    ) / M
    yim = (
        jnp.einsum("mk,...kn->...mn", CM, zim, precision=precision)
        + jnp.einsum("mk,...kn->...mn", SM, zre, precision=precision)
    ) / M
    return jnp.matmul(yre, WCT, precision=precision) - jnp.matmul(
        yim, WST, precision=precision
    )


class BlurOperator:
    """Circular convolution A (and A^T) as an rfft-diagonal multiply.

    Mirrors the reference closures A/AT (run_Gaussian_demo.m:136-137) but on
    the half-spectrum.  Stateless apart from cached DFT factor matrices and
    Parseval weights; the OTF is passed in (it changes every SAPG step).
    """

    def __init__(self, shape, psf_size: int, dtype=jnp.float32, fft_mode: str = "fft",
                 precision=None):
        self.shape = tuple(shape)
        self.psf_size = int(psf_size)
        self.dtype = dtype
        cplx = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        self.factors = dft_factors(psf_size, shape, cplx)
        self.weights = rfft_weights(shape, dtype)
        self.dim = self.shape[0] * self.shape[1]
        # fft_mode: 'fft' = jnp.fft (the default; cuFFT on the GPU); 'dft' =
        # dense DFT matmuls (rdft_matrices docstring) — the hot-loop
        # transforms become batched matmuls.
        if fft_mode not in ("fft", "dft"):
            raise ValueError(f"fft_mode must be 'fft' or 'dft', got {fft_mode!r}")
        self.fft_mode = fft_mode
        self._rdft = rdft_matrices(shape, dtype) if fft_mode == "dft" else None
        # precision of the per-apply transform matmuls (NOT the OTF matmuls,
        # which always run HIGHEST — H feeds every gradient).  HIGH is TF32
        # on the GPU (about three decimal digits).
        self.precision = (
            jax.lax.Precision.HIGHEST if precision is None else precision
        )

    def otf(self, kernel: jnp.ndarray) -> jnp.ndarray:
        return otf_rfft(kernel, self.shape, self.factors)

    def otf_batched(self, kernels: jnp.ndarray) -> jnp.ndarray:
        """OTFs of a stack of kernels (B, s, s) -> (B, M, N//2+1) in ONE
        batched complex matmul pair (the SAPG step needs the PSF and all its
        parameter-gradient kernels every iteration; batching them saves
        2(B-1) small kernel launches per step)."""
        Fx, Fy = self.factors
        hp = jax.lax.Precision.HIGHEST
        k = kernels.astype(jnp.asarray(Fx).dtype)
        left = jnp.einsum("sm,bst->bmt", jnp.asarray(Fx), k, precision=hp)
        return jnp.einsum("bmt,tn->bmn", left, jnp.asarray(Fy), precision=hp)

    def otf_host(self, kernel) -> "np.ndarray":
        """OTF computed host-side (NumPy, f64) and returned as a NumPy array.

        Use for OTFs that become jit-closure constants: a host NumPy
        constant embeds directly into the compiled program.
        """
        import numpy as np

        Fx, Fy = self.factors
        k = np.asarray(kernel).astype(np.complex128)
        H = (np.asarray(Fx, np.complex128).T @ k) @ np.asarray(Fy, np.complex128)
        return H.astype(np.complex128 if self.dtype == jnp.float64 else np.complex64)

    def rfft_host(self, x) -> "np.ndarray":
        """Host-side rfft2 → NumPy array (same rationale as otf_host)."""
        import numpy as np

        out = np.fft.rfft2(np.asarray(x))
        return out.astype(
            np.complex128 if self.dtype == jnp.float64 else np.complex64
        )

    # Batched-FFT chunking: large batches run as sequential ≤8 Mpx FFT
    # dispatches via lax.map (1024² → 8 images/dispatch, 2048² → 2).  The
    # threshold was tuned on another backend and has not been re-measured
    # on the GPU.  Per-image FFT results differ from the one-dispatch batch
    # only at f32-epsilon (FFT-internal order); small sizes (tests, parity)
    # are ungated.
    _FFT_CHUNK_PX = 8 * 1024 * 1024

    def _chunked_fft(self, x, one):
        B = x.shape[0]
        C = max(1, self._FFT_CHUNK_PX // (self.shape[0] * self.shape[1]))
        if x.ndim != 3 or B <= C or B % C != 0 or max(self.shape) < 1024:
            return one(x)
        out = jax.lax.map(one, x.reshape((B // C, C) + x.shape[1:]))
        return out.reshape((B,) + out.shape[2:])

    def rfft(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.fft_mode == "dft":
            return rfft2_matmul(x, self._rdft, precision=self.precision)
        return self._chunked_fft(x, jnp.fft.rfft2)

    def irfft(self, xhat: jnp.ndarray) -> jnp.ndarray:
        if self.fft_mode == "dft":
            return irfft2_matmul(xhat, self._rdft, precision=self.precision).astype(self.dtype)
        return self._chunked_fft(
            xhat,
            lambda z: jnp.fft.irfft2(z, s=self.shape).astype(self.dtype),
        )

    def apply(self, x: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
        """A x = irfft2(H ∘ rfft2(x))."""
        return self.irfft(H * self.rfft(x))

    def apply_adjoint(self, x: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
        """A^T x = irfft2(conj(H) ∘ rfft2(x))."""
        return self.irfft(jnp.conj(H) * self.rfft(x))

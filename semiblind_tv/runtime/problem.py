"""Problem assembly: observation synthesis and derived algorithm constants.

Mirrors the driver-side setup of the reference demos
(run_Gaussian_demo.m:122-195):

  * BSNR-controlled noise level:
      sigma = ||Ax - mean(Ax)||_F / sqrt(d * 10^(BSNR/10))
  * sigma² search box from [BSNR_min, BSNR_max]
  * Lipschitz constant Lf = evMax² / sigma² with evMax = λ_max(AᵀA)
    (closed form max|H|² by default; the reference's power iteration is
    available via ops.lipschitz.power_iteration for parity)
  * MYULA steps: lambda = min(5/Lf, lambdaMax),
    gamma = gammaMult * gammaFrac / (Lf + 1/lambda)
"""
from __future__ import annotations

import dataclasses
import numpy as np

import jax
import jax.numpy as jnp

from semiblind_tv.models.psf_models import (
    GaussianPsfModel,
    IsotropicGaussianPsfModel,
    LaplacePsfModel,
    MoffatPsfModel,
    ParamSpec,
    PsfModel,
)
from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.lipschitz import max_eigenval_closed_form
from semiblind_tv.runtime.config import DemoConfig

__all__ = ["Problem", "build_problem", "synthesize_observation", "make_psf_model",
           "resolve_fft_mode", "resolve_fft_precision"]


def make_psf_model(cfg: DemoConfig, dtype=jnp.float32) -> PsfModel:
    if cfg.psf == "gaussian":
        return GaussianPsfModel(cfg.psf_size, cfg.phi, dtype)
    if cfg.psf == "laplace":
        return LaplacePsfModel(cfg.psf_size, dtype)
    if cfg.psf == "moffat":
        return MoffatPsfModel(cfg.psf_size, dtype)
    if cfg.psf == "isotropic_gaussian":
        return IsotropicGaussianPsfModel(cfg.psf_size, cfg.phi, dtype)
    raise ValueError(f"unknown psf family: {cfg.psf!r}")


def synthesize_observation(x, H, blur: BlurOperator, bsnr, key):
    """y = A x + sigma * noise with BSNR-controlled sigma (run_Gaussian_demo.m:144-168)."""
    Ax = blur.apply(x, H)
    d = x.size
    sigma = jnp.linalg.norm(Ax - jnp.mean(Ax)) / jnp.sqrt(d * 10.0 ** (bsnr / 10.0))
    noise = jax.random.normal(key, x.shape, x.dtype)
    y = Ax + sigma * noise
    return y, sigma, Ax


def _sigma_for_bsnr(Ax, d, bsnr):
    return jnp.linalg.norm(Ax - jnp.mean(Ax)) / jnp.sqrt(d * 10.0 ** (bsnr / 10.0))


@dataclasses.dataclass
class Problem:
    """A fully-assembled semi-blind deblurring problem instance."""

    cfg: DemoConfig
    model: PsfModel
    blur: BlurOperator
    x_true: jnp.ndarray
    y: jnp.ndarray
    yhat: jnp.ndarray              # rfft2(y), precomputed for the fused SAPG step
    H_true: jnp.ndarray
    kernel_true: jnp.ndarray
    sigma_true: jnp.ndarray        # noise std used to synthesize y
    sigma2_init: jnp.ndarray
    sigma2_box: tuple              # (min, max) projection interval for sigma²
    ev_max: jnp.ndarray
    Lf: jnp.ndarray
    lambda_myula: jnp.ndarray
    gamma: jnp.ndarray
    gamma_max: jnp.ndarray

    @property
    def dim(self) -> int:
        return self.x_true.size

    def sigma_spec(self) -> ParamSpec:
        """ParamSpec for sigma² with the BSNR-derived box (built at runtime)."""
        return ParamSpec(
            name="sigma2",
            init=float(self.sigma2_init),
            box=(float(self.sigma2_box[0]), float(self.sigma2_box[1])),
            step_scale=self.cfg.sigma_step_scale,
            sign=+1.0,
            fix=self.cfg.fix_sigma,
            true_value=float(self.sigma2_init) if self.cfg.fix_sigma else None,
        )


def resolve_fft_mode(shape) -> str:
    """Auto transform backend: jnp.fft (cuFFT on the GPU) at every size and
    on every backend, which is exact to the FFT's rounding.  The
    matmul-DFT form (fft_mode='dft') stays selectable, and the row-sharded
    estimator (parallel/spatial.py) requires it."""
    del shape
    return "fft"


_PRECISIONS = {
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def resolve_fft_precision(name=None):
    """Matmul precision of the per-apply dft transforms.  Auto is HIGHEST
    (full f32) on every backend.  'high' stays an option: on the GPU it
    runs the matmuls in TF32, which keeps about three decimal digits."""
    return _PRECISIONS["highest" if name is None else name]


def build_problem(
    x: jnp.ndarray,
    cfg: DemoConfig,
    key,
    dtype=jnp.float32,
) -> Problem:
    """Assemble a Problem from a ground-truth image and a DemoConfig."""
    x = jnp.asarray(x, dtype)
    model = make_psf_model(cfg, dtype)
    fft_mode = cfg.sapg.fft_mode
    if fft_mode is None:
        fft_mode = resolve_fft_mode(x.shape)
    blur = BlurOperator(
        x.shape, cfg.psf_size, dtype, fft_mode=fft_mode,
        precision=resolve_fft_precision(cfg.sapg.fft_precision),
    )
    d = x.size

    true_params = {k: jnp.asarray(v, dtype) for k, v in cfg.true_psf_params().items()}

    # All setup numerics run under ONE jit.  Complex precomputes (OTF, yhat)
    # are then derived host-side from the real outputs.
    def _setup(x, true_params, key):
        kernel_true = model.kernel(true_params)
        H_true = blur.otf(kernel_true)
        ev_max = max_eigenval_closed_form(H_true)
        Ax = blur.apply(x, H_true)
        sigma = _sigma_for_bsnr(Ax, d, cfg.bsnr)
        s_a = _sigma_for_bsnr(Ax, d, cfg.bsnr_min) ** 2   # larger noise
        s_b = _sigma_for_bsnr(Ax, d, cfg.bsnr_max) ** 2   # smaller noise
        noise = jax.random.normal(key, x.shape, dtype)
        y = Ax + sigma * noise
        s_min = jnp.minimum(s_a, s_b)
        s_max = jnp.maximum(s_a, s_b)
        sigma2_init = sigma**2 if cfg.fix_sigma else (s_a + s_b) / 2.0
        # Lipschitz constant: the reference computes lf(sigma2) = evMax²/sigma2
        # at both ends of the BSNR box and takes min (Gaussian/Moffat) or max
        # (Laplace) — run_Gaussian_demo.m:177-179, run_laplace_demo.m:135.
        lf_a = ev_max**2 / s_a
        lf_b = ev_max**2 / s_b
        agg = jnp.minimum if cfg.sapg.lipschitz_agg == "min" else jnp.maximum
        Lf = agg(lf_a, lf_b)
        lam = cfg.sapg.lambda_scale * jnp.minimum(5.0 / Lf, cfg.sapg.lambda_max)
        gamma_max = 1.0 / (Lf + 1.0 / lam)
        gamma = (
            cfg.sapg.gamma_scale
            * cfg.sapg.gamma_multiplier
            * cfg.sapg.gamma_frac
            * gamma_max
        )
        return dict(
            kernel_true=kernel_true, ev_max=ev_max, sigma=sigma, s_min=s_min,
            s_max=s_max, sigma2_init=sigma2_init, Lf=Lf, lam=lam,
            gamma_max=gamma_max, gamma=gamma, y=y,
        )

    S = jax.jit(_setup)(x, true_params, key)
    kernel_true, sigma, y = S["kernel_true"], S["sigma"], S["y"]
    s_min, s_max, sigma2_init = S["s_min"], S["s_max"], S["sigma2_init"]
    ev_max, Lf, lam, gamma_max, gamma = (
        S["ev_max"], S["Lf"], S["lam"], S["gamma_max"], S["gamma"],
    )

    H_true = blur.otf_host(np.asarray(kernel_true))

    return Problem(
        cfg=cfg,
        model=model,
        blur=blur,
        x_true=x,
        y=y,
        # host-resident: becomes a jit-closure constant in the SAPG scan
        yhat=blur.rfft_host(y),
        H_true=H_true,
        kernel_true=kernel_true,
        sigma_true=sigma,
        sigma2_init=jnp.asarray(sigma2_init, dtype),
        sigma2_box=(s_min, s_max),
        ev_max=ev_max,
        Lf=Lf,
        lambda_myula=jnp.asarray(lam, dtype),
        gamma=jnp.asarray(gamma, dtype),
        gamma_max=jnp.asarray(gamma_max, dtype),
    )

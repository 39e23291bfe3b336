"""Typed configuration tree with per-demo presets.

The reference hard-codes two structs per driver: `op` (algorithm + model
config — run_Gaussian_demo.m:46-89) and `c` (per-parameter SA step scales —
run_Gaussian_demo.m:34-39; hard-coded constants inside
SAPG_algorithm_laplace.m:139-141 and SAPG_algorithm_moffat.m:135-138).
Every field of those structs is represented here; the three presets mirror
the three demo drivers including their deliberate quirks (the Laplace demo's
10x gamma and lambdaMax=0.1 — run_laplace_demo.m:39,142 — and its `max`
rather than `min` aggregation of the Lipschitz bound — run_laplace_demo.m:135).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from semiblind_tv.models.psf_models import ParamSpec

__all__ = [
    "SAPGConfig",
    "SALSAConfig",
    "DemoConfig",
    "gaussian_preset",
    "laplace_preset",
    "moffat_preset",
    "isotropic_preset",
    "preset",
]


@dataclasses.dataclass(frozen=True)
class SAPGConfig:
    """SAPG + MYULA loop configuration (reference `op` struct)."""

    samples: int = 20_000           # op.samples
    warmup: int = 15_000            # op.warmup
    burn_in: Optional[int] = None   # op.burnIn; default = 80% of samples
    lambda_max: float = 2.0         # op.lambdaMax
    gamma_frac: float = 0.98        # op.gammaFrac
    gamma_multiplier: float = 1.0   # Laplace demo multiplies gamma by 10 (run_laplace_demo.m:142)
    d_exp: float = 0.8              # op.d_exp
    d_scale: Optional[float] = None  # op.d_scale; default = 0.01 / theta.init
    chambolle_iters: int = 25       # chambolleit (run_Gaussian_demo.m:188)
    chambolle_tau: float = 0.249
    chambolle_tol: float = 1e-3
    stop_tol: float = 1e-5          # op.stopTol — recorded, never triggers a stop
                                    # (the reference SAPG loops compute tolerances
                                    # but contain no break; parity keeps fixed trips)
    lipschitz_agg: str = "min"      # min (Gaussian/Moffat) or max (Laplace)
    lambda_scale: float = 1.0       # c.lam (run_Gaussian_demo.m:38)
    gamma_scale: float = 1.0        # c.gam (run_Gaussian_demo.m:39)
    fft_mode: Optional[str] = None  # hot-loop transform backend: 'fft' =
                                    # jnp.fft (cuFFT on the GPU), 'dft' =
                                    # dense DFT matmuls (ops/fourier.py::
                                    # rdft_matrices; the row-sharded
                                    # estimator requires it).  None = auto:
                                    # 'fft' (runtime/problem.resolve_fft_mode)
    fft_precision: Optional[str] = None
                                    # matmul precision of the per-apply dft
                                    # transforms: 'highest' (full f32) or
                                    # 'high' (TF32 on the GPU, about three
                                    # decimal digits).  None = auto:
                                    # 'highest'.  OTF matmuls ALWAYS run
                                    # HIGHEST.
    track_traces: bool = True       # record per-iteration diagnostics
    theta_log_scale: bool = False   # SAPG Algorithm-1 style eta=log(theta)
                                    # updates (SALSA/SAPG_algorithm_1.m:180-182);
                                    # the live demos use the linear scale
    positivity: bool = True         # abs() projection in the MYULA step
                                    # (SAPG_algorithm_Guassian.m:161); the
                                    # legacy Algorithm-1 sampler omits it
                                    # (SALSA/SAPG_algorithm_1.m:173-174)
    sigma_log_scale: bool = False   # EXTENSION: log-space sigma² SA updates
                                    # (geometric-mean EB); off = reference
                                    # linear updates
    psf_log_scale: bool = False     # EXTENSION: log-space SA updates for the
                                    # free PSF parameters (chain-rule factor
                                    # p, box clipped in log space) — a probe
                                    # for the degenerate axes (w1, Moffat β)
                                    # mirroring sigma_log_scale; off = the
                                    # reference's linear updates
                                    # (SAPG_algorithm_Guassian.m:170-185)
    track_posterior_moments: bool = False  # EXTENSION: Welford running
                                    # posterior mean/variance of X over the
                                    # post-burn-in samples (the reference's
                                    # commented-out `weldford`/`posteriormean`
                                    # intent, SAPG_algorithm_Guassian.m:233-247,292)

    @property
    def burn_in_resolved(self) -> int:
        return self.burn_in if self.burn_in is not None else (self.samples * 80) // 100


@dataclasses.dataclass(frozen=True)
class SALSAConfig:
    """SALSA MAP-solve configuration (run_Gaussian_demo.m:219-242)."""

    outer_iters: int = 500
    tol: float = 1e-5
    stop_criterion: int = 1     # 1: rel-Δobjective, 2: rel-Δx, 3: objective target
    tv_iters: int = 10
    mu_factor: float = 0.1      # mu = theta_EB * mu_factor


@dataclasses.dataclass(frozen=True)
class DemoConfig:
    """Full experiment description — one reference demo driver."""

    psf: str                          # 'gaussian' | 'laplace' | 'moffat'
    psf_size: int = 7
    phi: float = 0.0
    bsnr: float = 30.0
    bsnr_min: float = 15.0
    bsnr_max: float = 45.0
    theta: ParamSpec = ParamSpec(
        name="theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0
    )
    sigma_step_scale: float = 1000.0
    fix_sigma: bool = False
    psf_params: Tuple[ParamSpec, ...] = ()
    sapg: SAPGConfig = SAPGConfig()
    salsa: SALSAConfig = SALSAConfig()
    image: str = "wheel"              # demos default to testImg{8} = wheel.png
    seed: int = 1

    def true_psf_params(self) -> Dict[str, float]:
        return {s.name: s.true_value for s in self.psf_params}

    def init_psf_params(self) -> Dict[str, float]:
        # When a parameter is fixed, the drivers overwrite its init with the
        # true value (run_Gaussian_demo.m:102-107, run_laplace_demo.m:77-79).
        return {
            s.name: (s.true_value if s.fix else s.init) for s in self.psf_params
        }


def gaussian_preset(
    fix_w1: bool = True,
    fix_w2: bool = True,
    fix_sigma: bool = False,
    w1: float = 0.4,
    w2: float = 0.3,
    **overrides,
) -> DemoConfig:
    """run_Gaussian_demo.m:32-89 (defaults fix_w1=fix_w2=1, fix_sigma=0)."""
    return DemoConfig(
        psf="gaussian",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0),
        sigma_step_scale=1000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("w1", init=0.5, box=(0.1, 1.0), step_scale=10.0, fix=fix_w1, true_value=w1),
            ParamSpec("w2", init=0.3, box=(0.1, 1.0), step_scale=10.0, fix=fix_w2, true_value=w2),
        ),
        sapg=SAPGConfig(lambda_max=2.0, lipschitz_agg="min"),
        **overrides,
    )


def laplace_preset(
    fix_b: bool = False, fix_sigma: bool = False, b: float = 0.3, **overrides
) -> DemoConfig:
    """run_laplace_demo.m:34-80 (lambdaMax=0.1, gamma 10x, Lf via max)."""
    return DemoConfig(
        psf="laplace",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0),
        sigma_step_scale=10_000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("b", init=0.1, box=(1e-3, 1.0), step_scale=100.0, fix=fix_b, true_value=b),
        ),
        sapg=SAPGConfig(lambda_max=0.1, gamma_multiplier=10.0, lipschitz_agg="max"),
        **overrides,
    )


def moffat_preset(
    fix_alpha: bool = False,
    fix_beta: bool = False,
    fix_sigma: bool = False,
    alpha: float = 0.4,
    beta: float = 3.5,
    **overrides,
) -> DemoConfig:
    """run_moffat_demo.m:33-84 (BSNR range [18, 35], c_theta=0.1)."""
    return DemoConfig(
        psf="moffat",
        bsnr_min=18.0,
        bsnr_max=35.0,
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.1, sign=+1.0),
        sigma_step_scale=10_000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("alpha", init=1.0, box=(1e-2, 1.0), step_scale=10.0, fix=fix_alpha, true_value=alpha),
            ParamSpec("beta", init=10.0, box=(0.1, 10.0), step_scale=10_000.0, fix=fix_beta, true_value=beta),
        ),
        sapg=SAPGConfig(lambda_max=2.0, lipschitz_agg="min"),
        **overrides,
    )


def isotropic_preset(
    fix_w: bool = False, w: float = 0.5, **overrides
) -> DemoConfig:
    """SIAM 4.2.1 capability (SALSA/run_deblur_tv.m intent): isotropic
    Gaussian with one unknown width, Algorithm-1 style SAPG (log-theta,
    no positivity projection), sigma² pinned."""
    return DemoConfig(
        psf="isotropic_gaussian",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=1.0, sign=+1.0),
        sigma_step_scale=0.0,
        fix_sigma=True,
        psf_params=(
            ParamSpec("w", init=0.8, box=(0.1, 2.0), step_scale=1.0, fix=fix_w, true_value=w),
        ),
        sapg=SAPGConfig(
            lambda_max=2.0, lipschitz_agg="min",
            theta_log_scale=True, positivity=False,
        ),
        **overrides,
    )


_PRESETS = {
    "gaussian": gaussian_preset,
    "laplace": laplace_preset,
    "moffat": moffat_preset,
    "isotropic_gaussian": isotropic_preset,
}


def preset(name: str, **kwargs) -> DemoConfig:
    return _PRESETS[name](**kwargs)

"""SAPG in a redundant-Haar synthesis representation with an L1 prior.

Capability of the reference's SIAM experiment 4.2.3
(`SALSA/run_deblur_synthesis_L1.m`): the unknown is the wavelet coefficient
field xw (d = (3L+1)·d_y for L levels), the forward model is A = B∘W
(uniform blur ∘ tight-frame synthesis), the prior is θ‖xw‖₁ with
soft-threshold prox, and θ is estimated by SAPG **Algorithm 1** (η = log θ
updates — SALSA/SAPG_algorithm_1.m:180-182, MYULA without positivity
projection).

NOTE (documented breakage): the reference script as shipped passes a
single-argument gradF into SAPG_algorithm_1, which calls gradF(X, tau) —
a MATLAB arity error — and never defines op.grad_t; i.e. the tau-estimation
leg cannot run.  We implement the working θ-only estimation the script
clearly intends.

Fused path: per iteration one synthesis (roll/add ladder), one rfft2,
one irfft2, one analysis — all inside a single lax.scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.wavelet import (
    ti_analysis,
    ti_synthesis,
    uniform_blur_kernel,
)

__all__ = ["WaveletL1Config", "WaveletL1Result", "run_sapg_wavelet_l1"]


@dataclasses.dataclass(frozen=True)
class WaveletL1Config:
    """run_deblur_synthesis_L1.m:54-66 parameter block."""

    samples: int = 3000
    burn_in: int = 20
    warmup: int = 0
    th_init: float = 0.01
    min_th: float = 1e-3
    max_th: float = 1.0
    d_exp: float = 0.8
    d_scale: Optional[float] = None    # default 0.1 / th_init  (NOT 0.01!)
    lambda_max: float = 2.0
    gamma_frac: float = 0.98
    bsnr: float = 30.0
    blur_length: int = 9
    levels: int = 4
    wavelet_order: int = 2             # daubcqf(N) filter length; 2 = the
                                       # reference's Haar configuration
                                       # (run_deblur_synthesis_L1.m:101)
    # SALSA MAP solve (run_deblur_synthesis_L1.m:160-183)
    salsa_iters: int = 500
    salsa_tol: float = 1e-4


@dataclasses.dataclass
class WaveletL1Result:
    theta_EB: float
    thetas: np.ndarray
    logPiTrace: np.ndarray
    xw_last: np.ndarray
    x_map: np.ndarray
    mse_db: float
    salsa_iters: int


def soft(x, t):
    """sign(x)·max(|x|−t, 0) (the reference's proxG, run_deblur_synthesis_L1.m:138)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


def run_sapg_wavelet_l1(
    x_true,
    cfg: WaveletL1Config,
    key,
    dtype=jnp.float32,
):
    """Full experiment: observation synthesis → SAPG (θ) → SALSA MAP."""
    if cfg.levels < 1:
        raise ValueError(f"levels must be >= 1, got {cfg.levels}")
    x_true = jnp.asarray(x_true, dtype)
    m, n = x_true.shape
    d_img = m * n
    L = cfg.levels
    d_w = d_img * (3 * L + 1)
    blur = BlurOperator((m, n), cfg.blur_length, dtype)
    w = blur.weights

    # uniform centered blur (SALSA/uniform_blur.m) — full-size kernel, so the
    # OTF comes from a host-side rfft2, not the corner-pad DFT factors
    kern = uniform_blur_kernel(m, cfg.blur_length)
    H = np.fft.rfft2(kern).astype(np.complex128 if dtype == jnp.float64 else np.complex64)
    ev_max = float(np.max(np.abs(np.fft.fft2(kern)) ** 2))  # λ_max(BᵀB)

    key, k_noise, k_chain = jax.random.split(key, 3)

    def B(v):
        return blur.irfft(H * blur.rfft(v))

    def BT(v):
        return blur.irfft(np.conj(H) * blur.rfft(v))

    def W(xw):
        return ti_synthesis(xw, L, cfg.wavelet_order)

    def WT(v):
        return ti_analysis(v, L, cfg.wavelet_order)

    setup = jax.jit(
        lambda x, k: (
            lambda Bx: (
                Bx,
                jnp.linalg.norm(Bx - jnp.mean(Bx))
                / jnp.sqrt(d_img * 10.0 ** (cfg.bsnr / 10.0)),
            )
        )(B(x))
    )
    Bx, sigma = setup(x_true, k_noise)
    y = Bx + sigma * jax.random.normal(k_noise, (m, n), dtype)
    sigma2 = sigma**2
    yhat = blur.rfft_host(y)

    Lf = ev_max / float(sigma) ** 2  # (evMax/sigma)^2 with evMax=λmax(BᵀB): ref :144
    lam = min(5.0 / Lf, cfg.lambda_max)
    gamma = cfg.gamma_frac / (Lf + 1.0 / lam)
    d_scale = cfg.d_scale if cfg.d_scale is not None else 0.1 / cfg.th_init

    min_eta, max_eta = np.log(cfg.min_th), np.log(cfg.max_th)

    def gradF(xw):
        rhat = H * blur.rfft(W(xw)) - yhat
        return WT(blur.irfft(np.conj(H) * rhat)) / sigma2, rhat

    def logpi(rhat, g1, theta):
        re, im = rhat.real, rhat.imag
        res2 = jnp.sum(w * (re * re + im * im)) / d_img
        return -res2 / (2.0 * sigma2) - theta * g1

    def step(carry, ii):
        xw, prox_c, key, theta = carry
        gF, _ = gradF(xw)
        key, sub = jax.random.split(key)
        Z = jax.random.normal(sub, xw.shape, dtype)
        # Algorithm-1 MYULA: no abs() (SAPG_algorithm_1.m:173)
        xw_n = xw + gamma * (prox_c - xw) / lam - gamma * gF + jnp.sqrt(2 * gamma) * Z
        prox_n = soft(xw_n, lam * theta)
        g1 = jnp.sum(jnp.abs(xw_n))
        delta_i = d_scale * ii ** (-cfg.d_exp) / d_w
        eta = jnp.log(theta)
        eta_n = jnp.clip(eta + delta_i * (d_w / theta - g1) * theta, min_eta, max_eta)
        theta_n = jnp.exp(eta_n)
        _, rhat = gradF(xw_n)
        lp = logpi(rhat, g1, theta)
        return (xw_n, prox_n, key, theta_n), dict(theta=theta_n, logPi=lp)

    def _run(key):
        xw0 = WT(y)  # op.X0 = WT(y) (run_deblur_synthesis_L1.m:154)
        theta0 = jnp.asarray(cfg.th_init, dtype)
        prox0 = soft(xw0, lam * theta0)
        iis = jnp.arange(2.0, cfg.samples + 1.0, dtype=dtype)
        carry, traces = jax.lax.scan(step, (xw0, prox0, key, theta0), iis)
        return carry, traces

    (xw_last, _, _, _), traces = jax.jit(_run)(k_chain)
    thetas = np.concatenate([[cfg.th_init], np.asarray(traces["theta"])])
    etas = np.log(thetas[cfg.burn_in - 1 :])
    theta_EB = float(np.exp(np.mean(etas)))

    x_map, n_salsa = _salsa_l1_synthesis(
        y, yhat, H, blur, W, WT, theta_EB * float(sigma) ** 2, theta_EB,
        cfg.salsa_iters, cfg.salsa_tol, L, dtype,
    )
    mse_db = float(10.0 * jnp.log10(jnp.sum((x_true - x_map) ** 2) / d_img))
    return WaveletL1Result(
        theta_EB=theta_EB,
        thetas=thetas,
        logPiTrace=np.concatenate([[0.0], np.asarray(traces["logPi"])]),
        xw_last=np.asarray(xw_last),
        x_map=np.asarray(x_map),
        mse_db=mse_db,
        salsa_iters=n_salsa,
    )


def _salsa_l1_synthesis(y, yhat, H, blur, W, WT, tau, mu, max_iter, tol, L, dtype):
    """SALSA with a synthesis L1 prior and Sherman-Morrison LS solve.

    invLS(r) = (r − WT(ifft(filter · fft(W r)))) / µ with
    filter = conj(H)·H/(|H|² + µ) — run_deblur_synthesis_L1.m:170-171;
    exact because W Wᵀ = I (tight frame).
    """
    d_img = y.size
    w = blur.weights
    filt = (np.conj(H) * H / (np.abs(H) ** 2 + mu)).astype(H.dtype)
    # conj(H)·yhat stays host-side NumPy; the irfft runs under jit
    aty_hat = np.conj(H) * np.asarray(yhat)
    ATy = jax.jit(lambda: WT(blur.irfft(jnp.asarray(aty_hat))))()
    thresh = tau / mu

    def invLS(r):
        return (r - WT(blur.irfft(filt * blur.rfft(W(r))))) / mu

    def objective(xw, u):
        rhat = jnp.asarray(yhat) - H * blur.rfft(W(xw))
        re, im = rhat.real, rhat.imag
        res2 = jnp.sum(w * (re * re + im * im)) / d_img
        return 0.5 * res2 + tau * jnp.sum(jnp.abs(u))

    def body(carry, k):
        xw, u, bu, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)
        un = soft(xw - bu, thresh)
        r = ATy + mu * (un + bu)
        xwn = invLS(r)
        bun = bu + (un - xwn)
        obj = objective(xwn, un)
        crit = jnp.abs(obj - prev_obj) / prev_obj
        newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)

        keep = lambda a, b: jnp.where(active, a, b)
        xw, u, bu = keep(xwn, xw), keep(un, u), keep(bun, bu)
        obj_out = jnp.where(active, obj, prev_obj)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly)
        return (xw, u, bu, obj_out, done, n_done), None

    xw0 = jnp.zeros((y.shape[0], y.shape[1] * (3 * L + 1)), dtype)

    def _solve(xw0):
        # objective(xw0) inside jit too, so the whole solve is one program
        init = (xw0, xw0, xw0, objective(xw0, xw0),
                jnp.array(False), jnp.zeros((), jnp.int32))
        return jax.lax.scan(body, init, jnp.arange(max_iter))[0]

    (xw, _, _, _, _, n_done) = jax.jit(_solve)(xw0)
    return W(xw), int(n_done)

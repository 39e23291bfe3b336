"""SALSA — ADMM MAP solver for min_x ½‖y − Ax‖² + τ·TV(x).

Re-design of the reference `SALSA/SALSA_v2.m:156-494` for the rfft-diagonal
blur operator:

  per outer iteration (SALSA_v2.m:423-440):
    u  ← prox_{τ/µ · TV}(x − b)      Chambolle, `TViters` inner iterations,
                                     dual variables warm-started across outer
                                     iterations ('dualvars', SALSA_v2.m:429)
    x  ← (AᵀA + µI)⁻¹ (Aᵀy + µ(u + b))   rfft-diagonal inverse:
                                     irfft2( (conj(H)·ŷ + µ·rfft2(u+b)) / (|H|²+µ) )
                                     (driver invLS — run_Gaussian_demo.m:224-226)
    b  ← b + u − x
  stop criteria 1/2/3 (SALSA_v2.m:455-469); demos use criterion 1
  (relative Δ objective < 1e-5) with 500 outer iterations max.

The early stop is expressed as a frozen-state `lax.scan` so the whole solve
is one compiled program with full objective/MSE/distance traces; `n_iters`
reports the iteration at which the stop criterion fired.

The LS step is fused in the frequency domain: Aᵀy is precomputed as
conj(H)·ŷ on the rfft grid, so each outer iteration costs ONE rfft2 + ONE
irfft2 (the reference spends 2 FFTs in invLS plus 2 more in the objective's
A·x — we evaluate the residual by Parseval instead).

COMPILE-ONCE DESIGN: the scan lives in ONE module-level jit with the OTF
(re/im planes), τ, µ, tolerance and the data as *arguments* and `blur` /
iteration counts as statics, so oracle sweeps and repeated MAP solves with
different EB estimates all hit the same compiled program (a per-call
jitted closure would retrace the whole scan on every invocation).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.tv import chambolle_prox, tv_norm

__all__ = ["SALSAResult", "salsa_tv", "soft_threshold"]


def soft_threshold(x, T):
    """Soft-threshold shrinkage (reference SALSA/soft.m:1-8, the default Psi)."""
    y = jnp.maximum(jnp.abs(x) - T, 0.0)
    return jnp.where(T == 0, x, y / (y + T) * x)


@dataclasses.dataclass
class SALSAResult:
    x: np.ndarray
    objective: np.ndarray       # length n_iters+1 (objective(1) = initial value)
    distance: np.ndarray
    mses: np.ndarray
    criterion: np.ndarray
    n_iters: int
    op_counts: Dict[str, int]   # callcounter parity: applies of A / AT / invLS


@partial(
    jax.jit,
    static_argnames=(
        "blur", "max_iter", "tv_iters", "stop_criterion",
        "compute_mse", "chambolle_tau", "chambolle_tol",
    ),
)
def _salsa_solve(
    y, Hre, Him, tau, mu, tol, x_true,
    blur, max_iter, tv_iters, stop_criterion, compute_mse,
    chambolle_tau, chambolle_tol,
):
    """One compiled program for the whole solve (see module docstring).

    `blur` is a static by object identity (BlurOperator is stateless apart
    from cached factor matrices); all per-call quantities are traced inputs,
    with the complex OTF carried as (re, im) planes."""
    dtype = blur.dtype
    d = y.size
    w = blur.weights
    H = jax.lax.complex(Hre, Him)
    yhat = blur.rfft(y)
    ATy_hat = jnp.conj(H) * yhat
    inv_filter = 1.0 / (Hre * Hre + Him * Him + mu)
    thresh = tau / mu
    norm_y2 = jnp.sum(y * y)

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return jnp.sum(w * (re * re + im * im)) / d

    def body(carry, k):
        x, u, bu, pux, puy, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)

        # warm-started duals: SALSA_v2's 'dualvars' (SALSA_v2.m:429)
        un, st = chambolle_prox(
            x - bu,
            thresh,
            tv_iters,
            tau=chambolle_tau,
            tol=chambolle_tol,
            duals=(pux, puy),
        )
        r = un + bu
        rhat = blur.rfft(r)
        xhat_n = inv_filter * (ATy_hat + mu * rhat)
        xn = blur.irfft(xhat_n)
        bun = bu + (un - xn)

        # objective via Parseval: ½‖y − A x‖² + τ TV(u)
        resid2 = pnorm2(yhat - H * xhat_n)
        obj = 0.5 * resid2 + tau * tv_norm(un)

        dist = jnp.linalg.norm(xn - un) / jnp.sqrt(
            jnp.sum(xn * xn) + jnp.sum(un * un)
        )

        if stop_criterion == 1:
            crit = jnp.abs(obj - prev_obj) / prev_obj
        elif stop_criterion == 2:
            crit = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn)
        else:
            crit = obj

        # the reference only evaluates the stop test from the 2nd outer
        # iteration (SALSA_v2.m:453 `if (outer>1)`)
        newly_done = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)

        # freeze state once converged (parity with the reference's break)
        def keep(new, old):
            return jnp.where(active, new, old)

        x = keep(xn, x)
        u = keep(un, u)
        bu = keep(bun, bu)
        pux = keep(st.px, pux)
        puy = keep(st.py, puy)
        obj_out = jnp.where(active, obj, prev_obj)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly_done)

        mse = (
            jnp.sum((x - x_true) ** 2) / d if compute_mse else jnp.zeros((), dtype)
        )
        trace = dict(
            objective=obj_out,
            distance=jnp.where(active, dist, jnp.zeros((), dtype)),
            mse=mse,
            criterion=jnp.where(active, crit, jnp.zeros((), dtype)),
        )
        return (x, u, bu, pux, puy, obj_out, done, n_done), trace

    x0 = jnp.zeros_like(y)
    obj0 = (0.5 * norm_y2).astype(dtype)  # resid = y − A·0
    init = (
        x0, x0, x0, x0, x0, obj0,
        jnp.array(False),
        jnp.zeros((), jnp.int32),
    )
    (x, *_rest, n_done), traces = jax.lax.scan(body, init, jnp.arange(max_iter))
    return x, traces, n_done, obj0


def salsa_tv(
    y: jnp.ndarray,
    H: jnp.ndarray,
    tau,
    mu,
    blur: BlurOperator,
    max_iter: int = 500,
    tol: float = 1e-5,
    tv_iters: int = 10,
    stop_criterion: int = 1,
    x_true: Optional[jnp.ndarray] = None,
    chambolle_tau: float = 0.249,
    chambolle_tol: float = 1e-3,
) -> SALSAResult:
    """TV-regularised SALSA with warm-started Chambolle duals.

    Matches SALSA_v2 called as the demos call it: TVINITIALIZATION=1,
    initialization x0 = 0 (SALSA_v2.m:379: x = AT(zeros) = 0 for this A).

    H may be a host NumPy OTF (blur.otf_host) — it is passed into the
    compiled solve as re/im planes.
    """
    dtype = blur.dtype
    y = jnp.asarray(y, dtype)
    d = y.size

    H = np.asarray(H)
    Hre = jnp.asarray(np.ascontiguousarray(H.real), dtype)
    Him = jnp.asarray(np.ascontiguousarray(H.imag), dtype)

    compute_mse = x_true is not None
    x_true_arr = (
        jnp.asarray(x_true, dtype) if compute_mse else jnp.zeros_like(y)
    )

    x, traces, n_done, obj0 = _salsa_solve(
        y, Hre, Him,
        jnp.asarray(tau, dtype), jnp.asarray(mu, dtype), jnp.asarray(tol, dtype),
        x_true_arr,
        blur, max_iter, tv_iters, stop_criterion, compute_mse,
        chambolle_tau, chambolle_tol,
    )

    traces = jax.tree_util.tree_map(np.asarray, traces)
    n_iters = int(n_done)
    mses = traces["mse"]
    if compute_mse:
        mse0 = float(jnp.sum(jnp.asarray(x_true, dtype) ** 2) / d)
        mses = np.concatenate([[mse0], mses])
    # operator-apply accounting (reference callcounter/global calls,
    # run_Gaussian_demo.m:210-218): per outer iteration SALSA_v2 applies
    # A once (objective) and invLS once; AT once up front.
    op_counts = {"A": 1 + n_iters, "AT": 1, "invLS": n_iters}
    return SALSAResult(
        x=np.asarray(x),
        objective=np.concatenate([[float(obj0)], traces["objective"]]),
        distance=traces["distance"],
        mses=mses,
        criterion=traces["criterion"],
        n_iters=n_iters,
        op_counts=op_counts,
    )

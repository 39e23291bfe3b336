"""C-SALSA — constrained SALSA:  min φ(Pᵀx)  s.t.  ‖Ax − y‖₂ ≤ ε.

Re-design of the reference `SALSA/CSALSA_v2.m:160-561` (and the older
synthesis-frame `SALSA/csalsa.m`) for the accelerator.  Per outer iteration
(CSALSA_v2.m:462-518):

    r   = µ1 P(u + bu) + µ2 Aᵀ(y + v + bv)
    x   = (µ2 AᵀA + µ1 I)⁻¹ r               caller LS solve ('LS' handle)
    u   = Ψ(Pᵀx − bu, 1/µ1)                 denoiser (TV: warm-started duals)
    ve  = Ax − y − bv;  v = ve·min(1, ε/‖ve‖)   (ε-ball projection, :483-489)
    bv ← bv − (Ax − y − v);  bu ← bu − (Pᵀx − u)
    µ1 ← δ·µ1, µ2 ← δ·µ2                    (continuation, :517-518)
    stop: rel-Δ criterion < tol  AND  ‖Ax − y‖ ≤ ε      (:520-545)

Default ε = sqrt(d + 8√d)·σ (CSALSA_v2.m:412-413).

Three surfaces:
  * `csalsa`       — the full generic option surface (caller A/Aᵀ/LS, Ψ/Φ
                     pair, P/Pᵀ analysis pair, TV-initialization mode, four
                     stop criteria, continuation) as a compile-once
                     fixed-trip scan with frozen-state masking.
  * `csalsa_tv`    — the TV specialization fused on the rfft half-spectrum
                     grid (one transform pair per iteration).
  * `csalsa_synthesis` — the older csalsa.m frame-synthesis prior
                     (unknown = frame coefficients, A = blur ∘ W) with the
                     Woodbury LS solve for Parseval frames
                     (csalsa.m:502,565-567).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.tv import chambolle_prox, tv_norm
from semiblind_tv.solvers.salsa import soft_threshold

__all__ = ["CSALSAResult", "csalsa", "csalsa_tv", "csalsa_synthesis"]


@dataclasses.dataclass
class CSALSAResult:
    x: np.ndarray
    objective: np.ndarray      # φ(x) per iteration
    criterion: np.ndarray      # ‖Ax − y‖ per iteration
    mses: np.ndarray
    n_iters: int
    distance1: Optional[np.ndarray] = None  # ‖Ax − y − v‖ (CSALSA_v2.m:496)
    distance2: Optional[np.ndarray] = None  # ‖Pᵀx − u‖   (CSALSA_v2.m:498)


def csalsa(
    y: jnp.ndarray,
    A: Callable,
    AT: Callable,
    invLS: Callable,
    mu1: float,
    mu2: float,
    *,
    sigma: Optional[float] = None,
    epsilon: Optional[float] = None,
    prox: Optional[Callable] = None,
    phi: Optional[Callable] = None,
    P: Optional[Callable] = None,
    PT: Optional[Callable] = None,
    tv_init: bool = False,
    tv_iters: int = 5,
    delta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-3,
    stop_criterion: int = 3,
    x0=None,
    x_true=None,
) -> CSALSAResult:
    """Generic C-SALSA with the reference's full option surface
    (CSALSA_v2.m:88-137 option list, :462-518 loop, :520-545 stopping).

    Args mirror the MATLAB options:
      A/AT           forward operator pair (function handles; :273-296).
      invLS          LS solve handle applying (µ1 I + µ2 AᵀA)⁻¹ for tight
                     P (PPᵀ = I); called as invLS(r, mu1, mu2) each
                     iteration so continuation reaches it (the reference
                     passes the updated µ1, CSALSA_v2.m:471).
      prox           Ψ(v, tau) denoiser handle ('Psi'); default
                     soft-threshold (:348-349, SALSA/soft.m).
      phi            Φ objective handle ('Phi'); default ‖·‖₁, or TVnorm
                     under tv_init (:368-375).  NOTE the reference
                     evaluates the objective at x, not Pᵀx
                     (objective(outer) = phi(x), CSALSA_v2.m:499) — quirk
                     preserved; compose phi with PT if you want φ(Pᵀx).
      P/PT           analysis pair ('P'/'PT', default identity, :268-271);
                     u/bu live in Pᵀ-space (:483 splitting).
      tv_init        'TVINITIALIZATION': Chambolle TV prox with
                     warm-started dual variables replaces Ψ (Ψ/Φ ignored,
                     :331-333, :476); tv_iters = 'TViters' (default 5).
      stop_criterion 1 rel-Δ objective, 2 rel-Δ x, 3 rel-Δ criterion,
                     4 minimum-iteration-count (tol = the count); all AND
                     ‖Ax−y‖ ≤ ε (:520-545).
      x0             None → zeros ('INITIALIZATION' 0, the default);
                     "aty" → Aᵀy (option 2); or an explicit array.
    """
    d = y.size
    if epsilon is None:
        if sigma is None:
            raise ValueError("provide epsilon or sigma")
        epsilon = float(np.sqrt(d + 8.0 * np.sqrt(d)) * sigma)
    if P is None:
        P = lambda x: x
        PT = lambda x: x
    elif PT is None:
        raise ValueError("If you give P you must also give PT, and vice versa")
    if prox is None:
        prox = soft_threshold
    if phi is None:
        phi = (lambda x: tv_norm(x)) if tv_init else (lambda x: jnp.sum(jnp.abs(x)))

    aty = AT(y)
    dtype = aty.dtype
    if x0 is None:
        x_init = jnp.zeros_like(aty)
    elif isinstance(x0, str) and x0 == "aty":
        x_init = aty
    else:
        x_init = jnp.asarray(x0, dtype)

    compute_mse = x_true is not None
    x_true_arr = jnp.asarray(x_true, dtype) if compute_mse else None

    u0 = jnp.zeros_like(PT(x_init))
    eps = jnp.asarray(epsilon, dtype)

    def body(carry, k):
        x, u, bu, v, bv, pux, puy, m1, m2, prev_obj, prev_crit, done, n_done = carry
        active = jnp.logical_not(done)

        r = m1 * P(u + bu) + m2 * AT(y + v + bv)
        xn = invLS(r, m1, m2)
        ptx = PT(xn)

        if tv_init:
            un, st = chambolle_prox(
                jnp.real(ptx - bu), 1.0 / m1, tv_iters, duals=(pux, puy)
            )
            pux_n, puy_n = st.px, st.py
        else:
            un = prox(ptx - bu, 1.0 / m1)
            pux_n, puy_n = pux, puy

        Ax = A(xn)
        ve = Ax - y - bv
        n_ve = jnp.linalg.norm(ve)
        vn = jnp.where(n_ve <= eps, ve, ve / n_ve * eps)

        bvn = bv - (Ax - y - vn)
        bun = bu - (ptx - un)

        crit = jnp.linalg.norm(Ax - y)
        dist1 = jnp.linalg.norm(Ax - y - vn)
        dist2 = jnp.linalg.norm(ptx - un)
        obj = phi(xn)

        if stop_criterion == 1:
            sc_ok = jnp.abs(obj - prev_obj) / obj < tol
        elif stop_criterion == 2:
            sc_ok = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn) < tol
        elif stop_criterion == 3:
            sc_ok = jnp.abs(crit - prev_crit) / crit < tol
        elif stop_criterion == 4:
            sc_ok = k + 2 >= tol  # 'minimum number of iterations' (:543-545)
        else:
            raise ValueError(f"unknown stop criterion {stop_criterion}")
        # the reference checks from its first loop pass (outer = 2 compares
        # against the stored initial objective/criterion, CSALSA_v2.m:520-545)
        newly = jnp.logical_and(jnp.logical_and(sc_ok, crit <= eps), active)

        keep = lambda a, b: jnp.where(active, a, b)
        x, u, bu, v, bv = keep(xn, x), keep(un, u), keep(bun, bu), keep(vn, v), keep(bvn, bv)
        pux, puy = keep(pux_n, pux), keep(puy_n, puy)
        m1 = jnp.where(active, m1 * delta, m1)
        m2 = jnp.where(active, m2 * delta, m2)
        obj_out = jnp.where(active, obj, prev_obj)
        crit_out = jnp.where(active, crit, prev_crit)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly)
        mse = (
            jnp.sum((x - x_true_arr) ** 2) / x.size
            if compute_mse
            else jnp.zeros((), dtype)
        )
        trace = dict(
            objective=obj_out,
            criterion=crit_out,
            distance1=jnp.where(active, dist1, jnp.zeros((), dtype)),
            distance2=jnp.where(active, dist2, jnp.zeros((), dtype)),
            mse=mse,
        )
        return (x, u, bu, v, bv, pux, puy, m1, m2, obj_out, crit_out, done, n_done), trace

    init = (
        x_init, u0, jnp.zeros_like(u0), jnp.zeros_like(y), jnp.zeros_like(y),
        jnp.zeros_like(u0), jnp.zeros_like(u0),
        jnp.asarray(mu1, dtype), jnp.asarray(mu2, dtype),
        phi(x_init), jnp.linalg.norm(A(x_init) - y),
        jnp.array(False), jnp.zeros((), jnp.int32),
    )
    (x, *_, n_done), traces = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)

    traces = jax.tree_util.tree_map(np.asarray, traces)
    return CSALSAResult(
        x=np.asarray(x),
        objective=traces["objective"],
        criterion=traces["criterion"],
        mses=traces["mse"],
        n_iters=int(n_done),
        distance1=traces["distance1"],
        distance2=traces["distance2"],
    )


def csalsa_synthesis(
    y: jnp.ndarray,
    H,
    blur: BlurOperator,
    W: Callable,
    WT: Callable,
    mu1: float,
    mu2: float,
    **kwargs,
) -> CSALSAResult:
    """Frame-synthesis C-SALSA (the older `SALSA/csalsa.m` path): unknown =
    synthesis coefficients s, forward operator A = blur ∘ W
    (csalsa.m:377-379), solved with the generic loop.

    W : coefficients → image (synthesis, 'BASIS'); WT : image →
    coefficients (analysis, 'BASISTRANSPOSE').  W must be a Parseval frame
    (W Wᵀ = I on images — e.g. ops.wavelet.ti_synthesis/ti_analysis) so the
    LS solve uses the Woodbury identity with the rfft-diagonal filter
    |H|²/(|H|² + µ1/µ2) (csalsa.m:502,565-567):

        (µ1 I + µ2 Wᵀ AᵀA W)⁻¹ r = (r − Wᵀ irfft(filt · rfft(W r))) / µ1

    Continuation scales µ1 and µ2 together so the filter stays constant —
    exactly the reference, which builds filter_FFT once before the loop.
    Returns the coefficient estimate in `.x` (reference OUTPUTVARIABLE=1);
    the image is W(result.x).
    """
    H = np.asarray(H)
    absH2 = H.real**2 + H.imag**2
    tau_ratio = mu1 / mu2
    filt = absH2 / (absH2 + tau_ratio)

    A = lambda s: blur.irfft(jnp.asarray(H) * blur.rfft(W(s)))
    AT = lambda r: WT(blur.irfft(jnp.conj(jnp.asarray(H)) * blur.rfft(r)))

    def invLS(r, m1, m2):
        wr = W(r)
        return (r - WT(blur.irfft(jnp.asarray(filt, wr.dtype) * blur.rfft(wr)))) / m1

    return csalsa(y, A, AT, invLS, mu1, mu2, **kwargs)


def csalsa_tv(
    y: jnp.ndarray,
    H,
    mu1: float,
    mu2: float,
    blur: BlurOperator,
    sigma: Optional[float] = None,
    epsilon: Optional[float] = None,
    delta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    tv_iters: int = 10,
    x_true=None,
) -> CSALSAResult:
    dtype = blur.dtype
    y = jnp.asarray(y, dtype)
    d = y.size
    w = blur.weights

    H = np.asarray(H)  # host complex
    yhat = blur.rfft_host(y)
    absH2 = H.real**2 + H.imag**2

    if epsilon is None:
        if sigma is None:
            raise ValueError("provide epsilon or sigma")
        epsilon = float(np.sqrt(d + 8.0 * np.sqrt(d)) * sigma)

    compute_mse = x_true is not None
    x_true_arr = jnp.asarray(x_true, dtype) if compute_mse else None

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return jnp.sum(w * (re * re + im * im)) / d

    def body(carry, k):
        x, u, bu, v, bv, pux, puy, m1, m2, prev_obj, prev_crit, done, n_done = carry
        active = jnp.logical_not(done)

        # Aᵀ(y + v + bv) and the LS solve, fused on the rfft grid
        rhs_hat = blur.rfft(m1 * (u + bu)) + m2 * jnp.conj(H) * (
            jnp.asarray(yhat) + blur.rfft(v + bv)
        )
        xhat = rhs_hat / (m2 * absH2 + m1)
        xn = blur.irfft(xhat)

        un, st = chambolle_prox(
            xn - bu, 1.0 / m1, tv_iters, duals=(pux, puy)
        )

        Ax = blur.irfft(H * xhat)
        ve = Ax - y - bv
        n_ve = jnp.linalg.norm(ve)
        vn = jnp.where(n_ve <= epsilon, ve, ve / n_ve * epsilon)

        bvn = bv - (Ax - y - vn)
        bun = bu - (xn - un)

        crit = jnp.sqrt(pnorm2(H * xhat - jnp.asarray(yhat)))
        obj = tv_norm(xn)

        if stop_criterion == 1:
            sc = jnp.abs(obj - prev_obj) / obj
        elif stop_criterion == 2:
            sc = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn)
        else:
            sc = jnp.abs(crit - prev_crit) / crit
        newly = jnp.logical_and(
            jnp.logical_and(jnp.logical_and(sc < tol, crit <= epsilon), k >= 1),
            active,
        )

        keep = lambda a, b: jnp.where(active, a, b)
        x, u, bu, v, bv = keep(xn, x), keep(un, u), keep(bun, bu), keep(vn, v), keep(bvn, bv)
        pux, puy = keep(st.px, pux), keep(st.py, puy)
        m1 = jnp.where(active, m1 * delta, m1)
        m2 = jnp.where(active, m2 * delta, m2)
        obj_out = jnp.where(active, obj, prev_obj)
        crit_out = jnp.where(active, crit, prev_crit)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly)
        mse = (
            jnp.sum((x - x_true_arr) ** 2) / d if compute_mse else jnp.zeros((), dtype)
        )
        trace = dict(objective=obj_out, criterion=crit_out, mse=mse)
        return (x, u, bu, v, bv, pux, puy, m1, m2, obj_out, crit_out, done, n_done), trace

    z = jnp.zeros_like(y)
    init = (
        z, z, z, z, z, z, z,
        jnp.asarray(mu1, dtype), jnp.asarray(mu2, dtype),
        tv_norm(z), jnp.linalg.norm(y),
        jnp.array(False), jnp.zeros((), jnp.int32),
    )
    (x, *_, n_done), traces = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)

    traces = jax.tree_util.tree_map(np.asarray, traces)
    return CSALSAResult(
        x=np.asarray(x),
        objective=traces["objective"],
        criterion=traces["criterion"],
        mses=traces["mse"],
        n_iters=int(n_done),
    )

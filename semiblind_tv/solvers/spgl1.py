"""SPGL1 — spectral projected gradient for basis pursuit denoise.

Re-design of the vendored reference `SALSA/spgl1_v0.m:1-893` (van den Berg
& Friedlander's SPGL1; unused by the live demos but part of the solver-zoo
capability surface).  Two entry points:

  * spg_lasso: min ½‖Ax − b‖²  s.t.  ‖Wx‖₁ ≤ τ
      projected Barzilai–Borwein gradient descent with a nonmonotone
      (last-10) line search and exact sort-based (weighted) L1-ball
      projection.
  * spgl1_bpdn: min ‖Wx‖₁  s.t.  ‖Ax − b‖ ≤ σ
      Newton root-finding on the Pareto curve φ(τ) = ‖r(τ)‖ with
      φ'(τ) = −‖W⁻¹Aᵀr‖_∞ / ‖r‖  (the SPGL1 update
      τ ← τ + ‖r‖(‖r‖ − σ)/‖W⁻¹Aᵀr‖_∞; spgl1_v0.m's weighted-norm
      options.weights surface).

Operators: either the framework's rfft-diagonal blur (H + blur) or any
generic (A, At) callable pair — e.g. a dense matrix for oracle tests.
Complex data/operators are supported (spgl1_v0.m's complex surface): the
one-norm is the modulus sum, the soft threshold preserves phases
(jnp.sign(z) = z/|z|), and all line-search inner products are the real
parts of hermitian products (`_rdot`), which reduce to the plain sums for
real inputs.

The inner solver is one fixed-trip lax.scan (masked early exit); each
iteration costs one A and one Aᵀ apply plus one sort for the projection.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator

__all__ = [
    "SPGL1Result",
    "project_l1_ball",
    "project_weighted_l1_ball",
    "spg_lasso",
    "spgl1_bpdn",
]


@dataclasses.dataclass
class SPGL1Result:
    x: np.ndarray
    tau: float
    resid_norm: float
    n_iters: int
    n_newton: int


def _rdot(a, b):
    """Real inner product ⟨a, b⟩ (= Re Σ conj(a)·b); exact for real inputs."""
    return jnp.real(jnp.sum(jnp.conj(a) * b))


def project_l1_ball(v: jnp.ndarray, tau) -> jnp.ndarray:
    """Euclidean projection onto {x : ‖x‖₁ ≤ τ} (sort-based, exact).

    Complex v is supported (spgl1_v0.m's complex-data surface): |·| is the
    modulus and jnp.sign(z) = z/|z|, so the soft threshold shrinks moduli
    while preserving phases — the exact projection for the complex one-norm.
    """
    shape = v.shape
    u = jnp.abs(v).ravel()
    s = jnp.sort(u)[::-1]
    cums = jnp.cumsum(s)
    k = jnp.arange(1, u.size + 1, dtype=u.dtype)
    thresh_cand = (cums - tau) / k
    ok = s - thresh_cand > 0
    rho = jnp.max(jnp.where(ok, jnp.arange(u.size), -1))
    theta = jnp.maximum((cums[rho] - tau) / (rho + 1.0), 0.0)
    inside = jnp.sum(u) <= tau
    theta = jnp.where(inside, 0.0, theta)
    out = jnp.sign(v) * jnp.maximum(jnp.abs(v) - theta, 0.0)
    return out.reshape(shape)


def project_weighted_l1_ball(v: jnp.ndarray, tau, w: jnp.ndarray) -> jnp.ndarray:
    """Euclidean projection onto {x : Σ w_i|x_i| ≤ τ}, w_i > 0 (exact).

    The minimizer is the weighted soft threshold
    x_i = sign(v_i)·max(|v_i| − θ w_i, 0) with θ ≥ 0 the smallest value
    satisfying Σ w_i max(|v_i| − θ w_i, 0) ≤ τ.  Sorting the breakpoints
    z_i = |v_i|/w_i descending, on the active prefix of size k:
    θ_k = (Σ_{i≤k} w_i|v_i| − τ) / Σ_{i≤k} w_i², valid while z_(k) > θ_k.
    Reduces to project_l1_ball at w ≡ 1.
    """
    shape = v.shape
    u = jnp.abs(v).ravel()
    w = jnp.broadcast_to(jnp.asarray(w, u.dtype).ravel(), u.shape)
    z = u / w
    order = jnp.argsort(-z)
    wu = (w * u)[order]
    w2 = (w * w)[order]
    zs = z[order]
    cums_wu = jnp.cumsum(wu)
    cums_w2 = jnp.cumsum(w2)
    theta_cand = (cums_wu - tau) / cums_w2
    ok = zs - theta_cand > 0
    rho = jnp.max(jnp.where(ok, jnp.arange(u.size), -1))
    theta = jnp.maximum((cums_wu[rho] - tau) / cums_w2[rho], 0.0)
    inside = jnp.sum(w * u) <= tau
    theta = jnp.where(inside, 0.0, theta)
    out = jnp.sign(v).ravel() * jnp.maximum(u - theta * w, 0.0)
    return out.reshape(shape)


def _make_ops(H, blur):
    H = np.asarray(H)

    def A(v):
        return blur.irfft(H * blur.rfft(v))

    def At(v):
        return blur.irfft(np.conj(H) * blur.rfft(v))

    return A, At


def _resolve_ops(H, blur, A_ops):
    if A_ops is not None:
        return A_ops
    return _make_ops(H, blur)


def _subspace_step(A, At, x, r, opt_tol, piv_tol=1e-12, cg_iters: int = 8):
    """Active-face refinement (reference spgl1_v0.m:494-549 subspaceMin).

    When the active set has stabilized, the reference runs LSQR restricted
    to the support with the step confined to the current L1-ball face
    (orthogonal to the sign vector) and limited by the first sign change.
    Redesign: fixed-trip CGLS on the projected normal equations
    (mask + face projection applied to every direction — static shapes, no
    index gathers), then the same sign-change pivot limit.  Real x only
    (the reference disables subspace minimization for complex variables,
    spgl1_v0.m:270-273).
    """
    mask = (jnp.abs(x) >= opt_tol).astype(x.dtype)
    ebar = jnp.sign(x) * mask
    ne = jnp.maximum(jnp.sum(mask), 1.0)

    def proj(v):
        v = v * mask
        return v - (jnp.sum(v * ebar) / ne) * ebar

    # CGLS for min ‖A P dz − r‖² with P = face projection
    s0 = proj(At(r))
    p0 = s0
    g0 = jnp.sum(s0 * s0)

    def cg_body(_, carry):
        dx, p, s, gamma = carry
        q = A(proj(p))
        denom = jnp.sum(q * q)
        alpha = jnp.where(denom > 1e-30, gamma / denom, 0.0)
        dx = dx + alpha * p
        s = s - alpha * proj(At(q))
        gamma_n = jnp.sum(s * s)
        beta = jnp.where(gamma > 1e-30, gamma_n / gamma, 0.0)
        return dx, s + beta * p, s, gamma_n

    dx, _, _, _ = jax.lax.fori_loop(
        0, cg_iters, cg_body, (jnp.zeros_like(x), p0, s0, g0)
    )
    dx = proj(dx)

    # largest step before any coefficient crosses zero (sign-change pivots)
    block1 = (mask > 0) & (x < 0) & (dx > piv_tol)
    block2 = (mask > 0) & (x > 0) & (dx < -piv_tol)
    safe = lambda c, v: jnp.where(c, v, jnp.inf)
    alpha1 = jnp.min(safe(block1, -x / jnp.where(block1, dx, 1.0)))
    alpha2 = jnp.min(safe(block2, -x / jnp.where(block2, dx, 1.0)))
    alpha = jnp.minimum(1.0, jnp.minimum(alpha1, alpha2))
    return x + alpha * dx


def spg_lasso(
    b: jnp.ndarray,
    H,
    blur: Optional[BlurOperator],
    tau: float,
    x0: Optional[jnp.ndarray] = None,
    max_iter: int = 200,
    tol: float = 1e-6,
    history: int = 10,
    max_ls: int = 10,
    weights: Optional[jnp.ndarray] = None,
    A_ops: Optional[Tuple[Callable, Callable]] = None,
    subspace_min: bool = False,
    opt_tol: float = 1e-6,
):
    """Inner LASSO solver; returns (x, resid_norm, grad, n_iters).

    weights: optional positive per-coefficient weights — the constraint
    becomes ‖Wx‖₁ ≤ τ (reference options.weights, spgl1_v0.m).
    A_ops: optional (A, At) callables replacing the blur operator.
    subspace_min: active-face CGLS refinement once the support stabilizes
    between iterations (reference options.subspaceMin; real data only)."""
    dtype = blur.dtype if blur is not None else jnp.asarray(b).dtype
    b = jnp.asarray(b, dtype)
    rdtype = jnp.zeros((), dtype).real.dtype
    A, At = _resolve_ops(H, blur, A_ops)

    if weights is None:
        project = lambda v: project_l1_ball(v, tau)
    else:
        wgt = jnp.asarray(weights, rdtype)
        project = lambda v: project_weighted_l1_ball(v, tau, wgt)

    def f_and_g(x):
        r = A(x) - b
        return 0.5 * _rdot(r, r), At(r), r

    def body(carry, _):
        x, g, f, alpha, fbuf, done, n_done, prev_nnz = carry
        active = jnp.logical_not(done)
        fmax = jnp.max(fbuf)

        def ls_body(state):
            a, k = state
            return a * 0.5, k + 1

        def ls_cond(state):
            a, k = state
            xn = project(x - a * g)
            d = xn - x
            rn = A(xn) - b
            fn = 0.5 * _rdot(rn, rn)
            suff = fn <= fmax + 1e-4 * _rdot(g, d)
            return jnp.logical_and(jnp.logical_not(suff), k < max_ls)

        a_fin, _ = jax.lax.while_loop(ls_cond, ls_body, (alpha, 0))
        xn = project(x - a_fin * g)

        if subspace_min:
            # active-face refinement once the support pattern repeats
            # (reference activeVars nnzDiff == 0 trigger, spgl1_v0.m:498-507)
            nnz = jnp.abs(xn) >= opt_tol
            trigger = jnp.logical_and(jnp.all(nnz == prev_nnz), active)
            xn = jax.lax.cond(
                trigger,
                lambda v: project(_subspace_step(A, At, v, b - A(v), opt_tol)),
                lambda v: v,
                xn,
            )
            prev_nnz = jnp.where(active, nnz, prev_nnz)

        fn, gn, _ = f_and_g(xn)

        s = xn - x
        yv = gn - g
        sy = _rdot(s, yv)
        alpha_n = jnp.where(
            sy > 1e-12, jnp.clip(_rdot(s, s) / sy, 1e-6, 1e6), 1.0
        )
        step = jnp.linalg.norm(s) / jnp.maximum(jnp.linalg.norm(xn), 1.0)
        newly = jnp.logical_and(step < tol, active)

        keep = lambda aa, oo: jnp.where(active, aa, oo)
        fbuf = jnp.where(active, jnp.roll(fbuf, 1).at[0].set(fn), fbuf)
        carry = (
            keep(xn, x), keep(gn, g), keep(fn, f), keep(alpha_n, alpha),
            fbuf, jnp.logical_or(done, newly), n_done + active.astype(jnp.int32),
            prev_nnz,
        )
        return carry, None

    if x0 is None:
        x0 = jnp.zeros_like(b) if A_ops is None else jnp.zeros_like(At(b))
    x0 = project(jnp.asarray(x0, dtype))
    f0, g0, r0 = f_and_g(x0)
    fbuf0 = jnp.full((history,), f0, rdtype)
    alpha0 = 1.0 / jnp.maximum(jnp.max(jnp.abs(g0)), 1e-12)
    init = (
        x0, g0, f0, alpha0, fbuf0, jnp.array(False), jnp.zeros((), jnp.int32),
        jnp.abs(x0) >= opt_tol,
    )
    (x, g, f, _, _, _, n, _), _ = jax.jit(
        lambda i: jax.lax.scan(body, i, None, length=max_iter)
    )(init)
    resid = jnp.sqrt(2.0 * f)
    return x, resid, g, int(n)


def spgl1_bpdn(
    b: jnp.ndarray,
    H,
    blur: Optional[BlurOperator],
    sigma: float,
    max_newton: int = 10,
    inner_iter: int = 150,
    tol: float = 1e-3,
    weights: Optional[jnp.ndarray] = None,
    A_ops: Optional[Tuple[Callable, Callable]] = None,
    subspace_min: bool = False,
) -> SPGL1Result:
    """(Weighted) basis pursuit denoise via Pareto-curve Newton iteration.

    min ‖Wx‖₁ s.t. ‖Ax − b‖ ≤ σ.  The Pareto derivative with weights is
    φ'(τ) = −‖W⁻¹Aᵀr‖_∞/‖r‖ (the dual norm of the weighted one-norm),
    giving the Newton update τ ← τ + ‖r‖(‖r‖ − σ)/‖W⁻¹Aᵀr‖_∞."""
    dtype = blur.dtype if blur is not None else jnp.asarray(b).dtype
    A, At = _resolve_ops(H, blur, A_ops)
    b = jnp.asarray(b, dtype)
    tau = 0.0
    x = jnp.zeros_like(b) if A_ops is None else jnp.zeros_like(At(b))
    resid = float(jnp.linalg.norm(b))
    wgt = None if weights is None else jnp.asarray(weights, dtype)
    n_total = 0
    n_newton = 0
    for _ in range(max_newton):
        if resid <= sigma * (1.0 + tol):
            break
        z = At(A(x) - b)
        if wgt is not None:
            z = z / wgt
        g_inf = max(float(jnp.max(jnp.abs(z))), 1e-12)
        tau = tau + resid * (resid - sigma) / g_inf
        x, r, _, n = spg_lasso(
            b, H, blur, tau, x0=x, max_iter=inner_iter,
            weights=weights, A_ops=A_ops,
            # reference disables subspace min for complex x (spgl1_v0.m:270-273)
            subspace_min=subspace_min and not jnp.iscomplexobj(b),
        )
        resid = float(r)
        n_total += n
        n_newton += 1
    return SPGL1Result(
        x=np.asarray(x), tau=float(tau), resid_norm=resid,
        n_iters=n_total, n_newton=n_newton,
    )

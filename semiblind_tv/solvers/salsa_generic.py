"""Generic-operator SALSA: the reference's full call signature.

`solvers/salsa.py::salsa_tv` is the fused rfft-diagonal fast path used by
the demos.  `SALSA_v2.m` is more general: A may be any linear operator
(function handle or matrix) with caller-provided Aᵀ and LS-inverse, and
Psi/Phi any prox/regulariser pair with an optional P/Pᵀ analysis transform
(SALSA_v2.m:156-252).  This module reproduces that generality for operators
with no FFT diagonalisation (synthesis frames, masks, dense matrices):

    x = salsa(y, A=..., AT=..., inv_ls=..., prox=..., phi=..., mu=..., tau=...)

All callables must be jit-traceable; the solve is one frozen-state scan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.solvers.salsa import soft_threshold

__all__ = ["salsa", "salsa_v1"]


def _l1(x):
    return jnp.sum(jnp.abs(x))


@dataclasses.dataclass
class GenericSALSAResult:
    x: np.ndarray
    objective: np.ndarray
    n_iters: int


def salsa(
    y: jnp.ndarray,
    A: Callable,
    AT: Callable,
    inv_ls: Callable,               # r -> (AᵀA + µI)⁻¹ r (the 'LS' handle)
    tau: float,
    mu: float,
    prox: Optional[Callable] = None,   # (v, thresh) -> u; default soft (SALSA_v2.m:337)
    phi: Optional[Callable] = None,    # regulariser value; default L1
    P: Optional[Callable] = None,      # synthesis (default identity)
    PT: Optional[Callable] = None,     # analysis  (default identity)
    max_iter: int = 500,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x0: Optional[jnp.ndarray] = None,
) -> GenericSALSAResult:
    prox = prox if prox is not None else soft_threshold
    phi = phi if phi is not None else _l1
    P = P if P is not None else (lambda v: v)
    PT = PT if PT is not None else (lambda v: v)

    ATy = AT(y)
    thresh = tau / mu
    if x0 is None:
        x0 = jnp.zeros_like(ATy)

    def body(carry, k):
        x, u, bu, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)
        PTx = PT(x)
        un = prox(PTx - bu, thresh)
        r = ATy + mu * P(un + bu)
        xn = inv_ls(r)
        PTxn = PT(xn)
        bun = bu + (un - PTxn)
        resid = y - A(xn)
        obj = 0.5 * jnp.sum(resid * resid) + tau * phi(un)
        if stop_criterion == 1:
            crit = jnp.abs(obj - prev_obj) / prev_obj
        elif stop_criterion == 2:
            crit = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn)
        else:
            crit = obj
        newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)
        keep = lambda a, o: jnp.where(active, a, o)
        carry = (
            keep(xn, x), keep(un, u), keep(bun, bu),
            jnp.where(active, obj, prev_obj),
            jnp.logical_or(done, newly), n_done + active.astype(jnp.int32),
        )
        return carry, carry[3]

    u0 = PT(x0)
    resid0 = y - A(x0)
    obj0 = 0.5 * jnp.sum(resid0 * resid0) + tau * phi(u0)
    init = (x0, u0, jnp.zeros_like(u0), obj0, jnp.array(False), jnp.zeros((), jnp.int32))
    (x, *_, n_done), objs = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)
    return GenericSALSAResult(
        x=np.asarray(x),
        objective=np.concatenate([[float(obj0)], np.asarray(objs)]),
        n_iters=int(n_done),
    )


def salsa_v1(
    y: jnp.ndarray,
    A: Callable,
    AT: Callable,
    inv_ls: Callable,
    tau: float,
    mu: float,
    prox: Optional[Callable] = None,
    phi: Optional[Callable] = None,
    inner_iters: int = 1,
    max_iter: int = 500,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    x0: Optional[jnp.ndarray] = None,
    output: str = "x",               # 'x' or 'z' (SALSA.m outputvar, :558-562)
) -> GenericSALSAResult:
    """SALSA v1: Bregman outer loop with `inner_iters` (prox, LS) passes per
    dual update (SALSA/SALSA.m:476-502 — superseded by v2 in the reference's
    live path but kept as a distinct solver shape: v2 is the inner_iters=1,
    analysis-form specialisation).

    Per outer iteration:  repeat inner_iters times
        z ← prox(x − b, τ/µ);  x ← (AᵀA+µI)⁻¹(Aᵀy + µ(z+b))
    then  b ← b + (z − x);  objective = ½‖y−Ax‖² + τφ(x)  (SALSA.m:505).
    Fixed-trip scan with frozen-state masking; stop criteria 1/2/3 as in
    SALSA.m:514-530.
    """
    prox = prox if prox is not None else soft_threshold
    phi = phi if phi is not None else _l1
    ATy = AT(y)
    thresh = tau / mu
    if x0 is None:
        x0 = jnp.zeros_like(ATy)

    def body(carry, k):
        x, z, b, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)

        def inner(carry2, _):
            xi, _zi = carry2
            zn = prox(xi - b, thresh)
            xn = inv_ls(ATy + mu * (zn + b))
            return (xn, zn), None

        (xn, zn), _ = jax.lax.scan(inner, (x, z), None, length=inner_iters)
        bn = b + (zn - xn)
        resid = y - A(xn)
        obj = 0.5 * jnp.sum(resid * resid) + tau * phi(xn)
        if stop_criterion == 1:
            crit = jnp.abs(obj - prev_obj) / prev_obj
        elif stop_criterion == 2:
            crit = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn)
        else:
            crit = obj
        newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)
        keep = lambda a, o: jnp.where(active, a, o)
        carry = (
            keep(xn, x), keep(zn, z), keep(bn, b),
            jnp.where(active, obj, prev_obj),
            jnp.logical_or(done, newly), n_done + active.astype(jnp.int32),
        )
        return carry, carry[3]

    resid0 = y - A(x0)
    obj0 = 0.5 * jnp.sum(resid0 * resid0) + tau * phi(x0)
    init = (x0, jnp.zeros_like(x0), jnp.zeros_like(x0), obj0,
            jnp.array(False), jnp.zeros((), jnp.int32))
    (x, z, *_, n_done), objs = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)
    return GenericSALSAResult(
        x=np.asarray(z if output == "z" else x),
        objective=np.concatenate([[float(obj0)], np.asarray(objs)]),
        n_iters=int(n_done),
    )

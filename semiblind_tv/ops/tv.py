"""Total-variation norm and the Chambolle dual-projection TV proximal operator.

Parity targets:

  * `tv_norm` — reference `utils/TVnorm.m:1-2` with *circular*-boundary
    backward differences (`SALSA/diffh.m`, `SALSA/diffv.m`, `SALSA/conv2c.m`):
    TV(x) = sum sqrt((x - roll_cols(x))² + (x - roll_rows(x))²).
  * `chambolle_prox` — reference `utils/chambolle_prox_TV_stop.m:120-166`:
    dual ascent p ← (p + τ∇u)/(1 + τ|∇u|) with τ = 0.249, *Neumann*-boundary
    divergence/gradient stencils, early exit on the fixed-point residual
    err ≤ tol (the reference's `cont = (k < MaxIter) & (err > tol)`),
    optional dual-variable warm start (used by SALSA), and recovery
    f = g - λ div p.

Note the deliberate boundary-condition discrepancy carried over from the
reference: TVnorm uses circular differences while the prox uses Neumann
stencils.  We preserve it because the SAPG trajectory (the theta gradient
uses TVnorm; the sampler uses the prox) depends on it.

The early exit is expressed as a masked fixed-trip-count `lax.fori_loop`
so the operator stays jit/vmap/scan-compatible: once the residual
drops below tol, subsequent iterations become no-ops — bit-identical to
breaking out of the loop.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["tv_norm", "divergence", "forward_gradient", "chambolle_prox", "ChambolleState"]


def tv_norm(x: jnp.ndarray) -> jnp.ndarray:
    """Isotropic TV with circular backward differences (utils/TVnorm.m)."""
    dh = x - jnp.roll(x, 1, axis=1)
    dv = x - jnp.roll(x, 1, axis=0)
    return jnp.sum(jnp.sqrt(dh * dh + dv * dv))


def divergence(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Neumann-boundary divergence (chambolle_prox_TV_stop.m:152-159).

    p1 pairs with rows, p2 with columns.  Row part:
      u[0] = p1[0];  u[i] = p1[i] - p1[i-1] (1 <= i <= M-2);  u[M-1] = -p1[M-1]
    and symmetrically for columns.
    """
    u = jnp.concatenate(
        [p1[:1, :], p1[1:-1, :] - p1[:-2, :], -p1[-1:, :]], axis=0
    )
    v = jnp.concatenate(
        [p2[:, :1], p2[:, 1:-1] - p2[:, :-2], -p2[:, -1:]], axis=1
    )
    return u + v


def forward_gradient(u: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward differences with zero last row/column (chambolle_prox_TV_stop.m:161-166)."""
    dux = jnp.concatenate([u[1:, :] - u[:-1, :], jnp.zeros_like(u[:1, :])], axis=0)
    duy = jnp.concatenate([u[:, 1:] - u[:, :-1], jnp.zeros_like(u[:, :1])], axis=1)
    return dux, duy


class ChambolleState(NamedTuple):
    px: jnp.ndarray
    py: jnp.ndarray
    iters: jnp.ndarray  # number of dual-ascent iterations actually applied
    err: jnp.ndarray    # last fixed-point residual


@partial(jax.jit, static_argnames=("max_iter",))
def chambolle_prox(
    g: jnp.ndarray,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> Tuple[jnp.ndarray, ChambolleState]:
    """prox_{λ TV}(g) = argmin_x ½||g - x||² + λ TV(x) by Chambolle dual ascent.

    Returns (f, state) where state carries the dual variables for warm
    starting (the reference's 'dualvars' option, used by SALSA_v2.m:429).
    """
    if duals is None:
        px = jnp.zeros_like(g)
        py = jnp.zeros_like(g)
    else:
        px, py = duals

    glam = g / lam

    def body(_, carry):
        px, py, k, err, active = carry
        divp = divergence(px, py)
        u = divp - glam
        upx, upy = forward_gradient(u)
        tmp = jnp.sqrt(upx * upx + upy * upy)
        rx = -upx + tmp * px
        ry = -upy + tmp * py
        step_err = jnp.sqrt(jnp.sum(rx * rx + ry * ry))
        denom = 1.0 + tau * tmp
        new_px = (px + tau * upx) / denom
        new_py = (py + tau * upy) / denom
        px = jnp.where(active, new_px, px)
        py = jnp.where(active, new_py, py)
        err = jnp.where(active, step_err, err)
        k = k + active.astype(k.dtype)
        active = jnp.logical_and(active, step_err > tol)
        return px, py, k, err, active

    init = (
        px,
        py,
        jnp.zeros((), jnp.int32),
        jnp.array(jnp.inf, g.dtype),
        jnp.array(True),
    )
    px, py, k, err, _ = jax.lax.fori_loop(0, max_iter, body, init)
    f = g - lam * divergence(px, py)
    return f, ChambolleState(px=px, py=py, iters=k, err=err)


@partial(jax.jit, static_argnames=("n_iter",))
def tv_denoise_circular(y: jnp.ndarray, lam, n_iter: int, tau: float = 0.249):
    """Circular-boundary Chambolle TV denoiser (reference SALSA/tvdenoising.m).

    Alternative to chambolle_prox with *circular* forward differences
    (conv2c stencils) and the multiplicative dual damping
    W = 1/(1 + (2/λ)τ|∇x|) (tvdenoising.m:83-89).  Solves
    argmin ½‖y−x‖² + λ·TV(x) up to the boundary-handling difference.
    """
    dh = lambda x: jnp.roll(x, -1, 1) - x   # conv2c(x, [1 -1 0])
    dv = lambda x: jnp.roll(x, -1, 0) - x
    dht = lambda x: jnp.roll(x, 1, 1) - x   # exact adjoint (conv2c [0 -1 1])
    dvt = lambda x: jnp.roll(x, 1, 0) - x

    def body(_, carry):
        Z1, Z2 = carry
        x = dht(Z1) + dvt(Z2) - y
        gx, gy = dh(x), dv(x)
        W = 1.0 / (1.0 + (2.0 / lam) * tau * jnp.sqrt(gx * gx + gy * gy))
        return (Z1 - tau * gx) * W, (Z2 - tau * gy) * W

    Z1, Z2 = jax.lax.fori_loop(0, n_iter, body, (jnp.zeros_like(y), jnp.zeros_like(y)))
    return y - dht(Z1) - dvt(Z2)


@partial(jax.jit, static_argnames=("n_iter",))
def projk_denoise(g: jnp.ndarray, lam, n_iter: int, tau: float = 0.25):
    """The reference's projk variant (SALSA/projk.m): circular backward-diff
    Q, per-component |q| damping (anisotropic normalisation), u = g − λQᵀp."""
    Q1 = lambda x: x - jnp.roll(x, 1, 1)    # conv2c(x, [0 1 -1])
    Q2 = lambda x: x - jnp.roll(x, 1, 0)
    Qs1 = lambda x: jnp.roll(x, -1, 1) - x  # conv2c(x, [1 -1 0])
    Qs2 = lambda x: jnp.roll(x, -1, 0) - x

    def body(_, carry):
        p1, p2 = carry
        u = Qs1(p1) + Qs2(p2) - g / lam
        q1, q2 = Q1(u), Q2(u)
        p1 = (p1 + tau * q1) / (1.0 + tau * jnp.abs(q1))
        p2 = (p2 + tau * q2) / (1.0 + tau * jnp.abs(q2))
        return p1, p2

    p1, p2 = jax.lax.fori_loop(0, n_iter, body, (jnp.zeros_like(g), jnp.zeros_like(g)))
    return g - lam * (Qs1(p1) + Qs2(p2))

"""CoRAL — ADMM with two compound regularizers:

    min_x ½‖y − Ax‖² + τ1·φ1(x) + τ2·φ2(x)

Re-design of the vendored reference `SALSA/CoRAL_v2.m:394-470` for the
rfft-diagonal blur operator.  Per outer iteration:

    u ← prox_{τ1/µ1 · φ1}(x − bu)         (TV via warm-started Chambolle,
    v ← prox_{τ2/µ2 · φ2}(x − bv)          or soft-threshold for L1)
    x ← (AᵀA + (µ1+µ2) I)⁻¹ (Aᵀy + µ1(u+bu) + µ2(v+bv))
    bu ← bu + u − x;   bv ← bv + v − x
    stop criteria 1/2/3 as in SALSA (CoRAL_v2.m:435-455)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.tv import chambolle_prox, tv_norm
from semiblind_tv.solvers.salsa import soft_threshold


def l1_norm(x):
    return jnp.sum(jnp.abs(x))

__all__ = ["CoRALResult", "coral_tv_l1", "coral"]


@dataclasses.dataclass
class CoRALResult:
    x: np.ndarray
    objective: np.ndarray
    mses: np.ndarray
    n_iters: int


def coral(
    y: jnp.ndarray,
    H,
    tau1: float,
    tau2: float,
    blur: BlurOperator,
    prox1: Callable,
    phi1: Callable,
    prox2: Callable,
    phi2: Callable,
    mu1: float = 1e-3,
    mu2: float = 1e-3,
    max_iter: int = 200,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    x_true=None,
) -> CoRALResult:
    """Generic two-regularizer ADMM.  prox_i(v, thresh) -> x."""
    dtype = blur.dtype
    y = jnp.asarray(y, dtype)
    d = y.size
    w = blur.weights
    H = np.asarray(H)
    yhat = blur.rfft_host(y)
    ATy_hat = np.conj(H) * yhat
    absH2 = H.real**2 + H.imag**2
    mu = mu1 + mu2
    inv_filter = (1.0 / (absH2 + mu)).astype(absH2.dtype)
    th1, th2 = tau1 / mu1, tau2 / mu2

    compute_mse = x_true is not None
    x_true_arr = jnp.asarray(x_true, dtype) if compute_mse else None

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return jnp.sum(w * (re * re + im * im)) / d

    def body(carry, k):
        x, u, bu, v, bv, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)

        un = prox1(x - bu, th1)
        vn = prox2(x - bv, th2)
        rhat = jnp.asarray(ATy_hat) + blur.rfft(mu1 * (un + bu) + mu2 * (vn + bv))
        xhat = inv_filter * rhat
        xn = blur.irfft(xhat)
        bun = bu + (un - xn)
        bvn = bv + (vn - xn)

        obj = (
            0.5 * pnorm2(jnp.asarray(yhat) - H * xhat)
            + tau1 * phi1(un)
            + tau2 * phi2(vn)
        )
        if stop_criterion == 1:
            crit = jnp.abs(obj - prev_obj) / prev_obj
        elif stop_criterion == 2:
            crit = jnp.linalg.norm(xn - x) / jnp.linalg.norm(xn)
        else:
            crit = obj
        newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)

        keep = lambda a, o: jnp.where(active, a, o)
        x, u, bu, v, bv = (
            keep(xn, x), keep(un, u), keep(bun, bu), keep(vn, v), keep(bvn, bv)
        )
        obj_out = jnp.where(active, obj, prev_obj)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly)
        mse = (
            jnp.sum((x - x_true_arr) ** 2) / d if compute_mse else jnp.zeros((), dtype)
        )
        return (x, u, bu, v, bv, obj_out, done, n_done), dict(objective=obj_out, mse=mse)

    z = jnp.zeros_like(y)
    obj0 = 0.5 * jnp.sum(y * y)
    init = (z, z, z, z, z, obj0.astype(dtype), jnp.array(False), jnp.zeros((), jnp.int32))
    (x, *_, n_done), traces = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)
    traces = jax.tree_util.tree_map(np.asarray, traces)
    return CoRALResult(
        x=np.asarray(x),
        objective=np.concatenate([[float(obj0)], traces["objective"]]),
        mses=traces["mse"],
        n_iters=int(n_done),
    )


def coral_tv_l1(
    y, H, tau_tv, tau_l1, blur, mu1=1e-3, mu2=1e-3, tv_iters=10,
    max_iter=200, tol=1e-4, x_true=None, tv_warm_start=False,
):
    """TV + L1 compound regularization (the canonical CoRAL configuration).

    tv_warm_start=True carries the Chambolle dual variables across outer
    iterations (the reference's TVINITIALIZATION leg, CoRAL_v2.m:401-403);
    False matches the reference default of a cold prox per iteration."""
    if not tv_warm_start:

        def prox_tv(vv, t):
            f, _ = chambolle_prox(vv, t, tv_iters)
            return f

        return coral(
            y, H, tau_tv, tau_l1, blur,
            prox_tv, tv_norm, soft_threshold, l1_norm,
            mu1=mu1, mu2=mu2, max_iter=max_iter, tol=tol, x_true=x_true,
        )

    # warm-started variant: thread the duals through a host-side closure is
    # impossible inside scan, so wrap coral's generic prox with a stateful
    # pair carried in a mutable cell updated via jax.lax side-band — instead
    # we inline a dedicated loop reusing coral's machinery with extra carry.
    return _coral_tv_l1_warm(
        y, H, tau_tv, tau_l1, blur, mu1, mu2, tv_iters, max_iter, tol, x_true
    )


def _coral_tv_l1_warm(y, H, tau1, tau2, blur, mu1, mu2, tv_iters, max_iter, tol, x_true):
    import numpy as np

    dtype = blur.dtype
    y = jnp.asarray(y, dtype)
    d = y.size
    w = blur.weights
    H = np.asarray(H)
    yhat = blur.rfft_host(y)
    ATy_hat = np.conj(H) * yhat
    mu = mu1 + mu2
    inv_filter = (1.0 / (H.real**2 + H.imag**2 + mu)).astype(np.float32 if dtype == jnp.float32 else np.float64)
    th1, th2 = tau1 / mu1, tau2 / mu2
    compute_mse = x_true is not None
    xt = jnp.asarray(x_true, dtype) if compute_mse else None

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return jnp.sum(w * (re * re + im * im)) / d

    def body(carry, k):
        x, u, bu, v, bv, pux, puy, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)
        un, st = chambolle_prox(x - bu, th1, tv_iters, duals=(pux, puy))
        vn = soft_threshold(x - bv, th2)
        rhat = jnp.asarray(ATy_hat) + blur.rfft(mu1 * (un + bu) + mu2 * (vn + bv))
        xhat = inv_filter * rhat
        xn = blur.irfft(xhat)
        bun = bu + (un - xn)
        bvn = bv + (vn - xn)
        obj = 0.5 * pnorm2(jnp.asarray(yhat) - H * xhat) + tau1 * tv_norm(un) + tau2 * l1_norm(vn)
        crit = jnp.abs(obj - prev_obj) / prev_obj
        newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)
        keep = lambda a, o: jnp.where(active, a, o)
        carry = (
            keep(xn, x), keep(un, u), keep(bun, bu), keep(vn, v), keep(bvn, bv),
            keep(st.px, pux), keep(st.py, puy),
            jnp.where(active, obj, prev_obj),
            jnp.logical_or(done, newly), n_done + active.astype(jnp.int32),
        )
        mse = jnp.sum((carry[0] - xt) ** 2) / d if compute_mse else jnp.zeros((), dtype)
        return carry, dict(objective=carry[7], mse=mse)

    z = jnp.zeros_like(y)
    obj0 = (0.5 * jnp.sum(y * y)).astype(dtype)
    init = (z, z, z, z, z, z, z, obj0, jnp.array(False), jnp.zeros((), jnp.int32))
    (x, *_, n_done), traces = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)
    traces = jax.tree_util.tree_map(np.asarray, traces)
    return CoRALResult(
        x=np.asarray(x),
        objective=np.concatenate([[float(obj0)], traces["objective"]]),
        mses=traces["mse"],
        n_iters=int(n_done),
    )

"""FISTA solvers for ½‖y − Ax‖² + τ·φ(x).

Re-design of the reference's FISTA variants (all "modified
deblur_wavelet_FISTA_sep" ports in the reference):

  * `SALSA/my_deblur_fista.m` — TV prox (Chambolle, 10 iters), x0 = 0, L = 1
  * `SALSA/my_fista.m`        — generic prox Psi, x0 = Aᵀy, caller L
  * `SALSA/my_fista_l1.m`     — soft-threshold in a synthesis dictionary W

Iteration (my_fista.m:22-30):
    y_k ← y_k − (1/L) Aᵀ(A y_k − b)
    x_k ← Psi(y_k, τ/L)
    t_{k+1} = (1 + sqrt(1 + 4 t_k²))/2
    y_{k+1} = x_k + ((t_k − 1)/t_{k+1})(x_k − x_old)
stop criteria 1/2/3 like SALSA.

Shape: the A-applications are rfft-diagonal multiplies; the whole solve
is one lax.scan with frozen-state early stop (same pattern as salsa_tv).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.tv import chambolle_prox, tv_norm

__all__ = ["FISTAResult", "fista_tv", "fista"]


@dataclasses.dataclass
class FISTAResult:
    x: np.ndarray
    objective: np.ndarray
    mses: np.ndarray
    n_iters: int


def fista(
    y: jnp.ndarray,
    H,
    tau,
    blur: BlurOperator,
    prox: Callable,                 # prox(v, step) -> x
    phi: Callable,                  # regulariser value for the objective
    L: float = 1.0,
    max_iter: int = 100,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x0: Optional[jnp.ndarray] = None,
    x_true: Optional[jnp.ndarray] = None,
) -> FISTAResult:
    dtype = blur.dtype
    y = jnp.asarray(y, dtype)
    d = y.size
    w = blur.weights
    H = np.asarray(H)  # host complex (see salsa_tv)
    yhat = blur.rfft_host(y)
    absH2 = H.real**2 + H.imag**2
    ATy_hat = np.conj(H) * yhat

    compute_mse = x_true is not None
    x_true_arr = jnp.asarray(x_true, dtype) if compute_mse else None

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return jnp.sum(w * (re * re + im * im)) / d

    def grad_step(v):
        # v − (1/L) Aᵀ(A v − y), fused on the rfft grid
        vhat = blur.rfft(v)
        return blur.irfft(vhat - (absH2 * vhat - ATy_hat) / L)

    def objective_of(x):
        xhat = blur.rfft(x)
        return 0.5 * pnorm2(yhat - H * xhat) + tau * phi(x)

    def body(carry, k):
        x, yk, t, prev_obj, done, n_done = carry
        active = jnp.logical_not(done)

        yg = grad_step(yk)
        xn = prox(yg, tau / L)
        tn = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        ykn = xn + ((t - 1.0) / tn) * (xn - x)

        obj = objective_of(xn)
        if stop_criterion == 1:
            crit = jnp.abs(obj - prev_obj) / obj
        elif stop_criterion == 2:
            crit = jnp.linalg.norm(xn - x) / jnp.sqrt(jnp.sum(xn * xn))
        else:
            crit = obj

        newly_done = jnp.logical_and(crit < tol, active)

        def keep(new, old):
            return jnp.where(active, new, old)

        x = keep(xn, x)
        yk = keep(ykn, yk)
        t = keep(tn, t)
        obj_out = jnp.where(active, obj, prev_obj)
        n_done = n_done + active.astype(jnp.int32)
        done = jnp.logical_or(done, newly_done)
        mse = (
            jnp.sum((x - x_true_arr) ** 2) / d if compute_mse else jnp.zeros((), dtype)
        )
        return (x, yk, t, obj_out, done, n_done), dict(objective=obj_out, mse=mse)

    if x0 is None:
        x0 = jnp.zeros_like(y)  # my_deblur_fista.m:22
    obj0 = objective_of(x0)
    init = (
        x0,
        x0,
        jnp.asarray(1.0, dtype),
        obj0,
        jnp.array(False),
        jnp.zeros((), jnp.int32),
    )

    (x, _, _, _, _, n_done), traces = jax.jit(
        lambda i: jax.lax.scan(body, i, jnp.arange(max_iter))
    )(init)

    traces = jax.tree_util.tree_map(np.asarray, traces)
    mses = traces["mse"]
    if compute_mse:
        mses = np.concatenate([[float(jnp.sum((x0 - x_true_arr) ** 2) / d)], mses])
    return FISTAResult(
        x=np.asarray(x),
        objective=np.concatenate([[float(obj0)], traces["objective"]]),
        mses=mses,
        n_iters=int(n_done),
    )


def fista_tv(
    y,
    H,
    tau,
    blur: BlurOperator,
    tv_iters: int = 10,
    L: float = 1.0,
    max_iter: int = 100,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x_true=None,
) -> FISTAResult:
    """TV-FISTA (my_deblur_fista.m): Chambolle prox, x0 = 0, L = 1."""

    def prox(v, step):
        f, _ = chambolle_prox(v, step, tv_iters)
        return f

    return fista(
        y, H, tau, blur, prox, tv_norm, L=L, max_iter=max_iter, tol=tol,
        stop_criterion=stop_criterion, x_true=x_true,
    )

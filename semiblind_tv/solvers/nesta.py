"""NESTA — Nesterov-smoothed L1/TV minimisation with continuation.

Re-design of the vendored reference solver (`SALSA/NESTA.m:105-233`,
`SALSA/Core_Nesterov.m:105-407`; unused by the live demos but part of the
solver-zoo capability surface).  Solves

    min_x  ||x||_1   or  TV(x)    s.t.  ||A x - b||_2 <= delta

via Nesterov's smoothing (smoothing parameter mu) and accelerated gradient
with the two-point (yk, zk) scheme, plus outer continuation that shrinks mu
geometrically from mu0 to muf (NESTA.m:155-171):

  per inner iteration k (Core_Nesterov.m:180-283):
    df      = ∇ f_mu(xk)      (smoothed TV or L1 gradient)
    yk      = P(xk − df/Lmu)          Lmu = 1/mu (L1) or 8/mu (TV)
    wk     += 0.5 (k+1) df
    zk      = P(xplug − wk/Lmu)
    x_{k+1} = τk zk + (1 − τk) yk,    τk = 2/(k+3)
  P is the delta-ball data-constraint projection, exact for AAᵀ = c·I and
  (as in the original NESTA paper and the vendored code) applied with the
  same formula for general A:
    λ = max(0, Lmu(||b − A c||/δ − 1)),  γ = λ/(λ + Lmu)
    P(c) = (λ/Lmu)(1−γ) Aᵀb + c − γ AᵀA c
  stop: relative variation of f_mu vs the mean of the last 10 values,
  double-triggered (Core_Nesterov.m:239-243); continuation re-enters with
  the previous solution as xplug.

All A-applications are rfft-diagonal multiplies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.tv import forward_gradient

__all__ = ["NESTAResult", "nesta"]


@dataclasses.dataclass
class NESTAResult:
    x: np.ndarray
    n_iters: int
    objective: np.ndarray   # f_mu per inner iteration (all continuation legs)
    residual: np.ndarray    # ||b - A x|| per inner iteration
    mu_final: float


def _smoothed_tv_grad(x, mu):
    """(∇f_mu, f_mu) for TV smoothing (Core_Nesterov.m Perform_TV_Constraint)."""
    def bands(v):
        dx, dy = forward_gradient(v)
        return jnp.stack([dx, dy])

    d = bands(x)
    mag = jnp.sqrt(d[0] ** 2 + d[1] ** 2)
    w = jnp.maximum(mu, mag)
    u = d / w
    fx = jnp.sum(u[0] * d[0] + u[1] * d[1]) - mu / 2.0 * jnp.sum(u * u)
    # df = Dᵀ u, exact adjoint of the forward-difference operator
    _, vjp = jax.vjp(bands, x)
    (df,) = vjp(u)
    return df, fx


def _smoothed_l1_grad(x, mu):
    """(∇f_mu, f_mu) for L1 smoothing (Perform_L1_Constraint, l2 prox)."""
    u = x / jnp.maximum(mu, jnp.abs(x))
    fx = jnp.sum(u * x) - mu / 2.0 * jnp.sum(u * u)
    return u, fx


def nesta(
    b: jnp.ndarray,
    H,
    blur: BlurOperator,
    muf: float,
    delta: float,
    type_min: str = "tv",
    max_int_iter: int = 5,
    max_iter: int = 500,
    tol_var: float = 1e-5,
    x_plug: Optional[jnp.ndarray] = None,
) -> NESTAResult:
    dtype = blur.dtype
    b = jnp.asarray(b, dtype)
    H = np.asarray(H)
    absH2 = H.real**2 + H.imag**2
    bhat = blur.rfft_host(b)
    Atb = blur.irfft(np.conj(H) * jnp.asarray(bhat))

    def A(v):
        return blur.irfft(H * blur.rfft(v))

    def AtA(v):
        return blur.irfft(absH2 * blur.rfft(v))

    grad = _smoothed_tv_grad if type_min == "tv" else _smoothed_l1_grad

    if x_plug is None:
        x_plug = Atb
    x_ref = x_plug

    if type_min == "tv":
        dx, dy = forward_gradient(x_ref)
        mu0 = float(jnp.max(jnp.sqrt(dx**2 + dy**2)))
    else:
        mu0 = 0.9 * float(jnp.max(jnp.abs(x_ref)))
    mu0 = max(mu0, muf)

    gamma_c = (muf / mu0) ** (1.0 / max_int_iter)
    gamma_t = (tol_var / 0.1) ** (1.0 / max_int_iter)

    def project(c, Lmu):
        """delta-ball constraint step (Core_Nesterov.m:228-234)."""
        Ac = A(c)
        nrm = jnp.linalg.norm(b - Ac)
        lam = jnp.maximum(0.0, Lmu * (nrm / delta - 1.0))
        g = lam / (lam + Lmu)
        return (lam / Lmu) * (1.0 - g) * Atb + c - g * AtA(c)

    def inner(xplug, mu, tolv):
        Lmu = (8.0 / mu) if type_min == "tv" else (1.0 / mu)

        def body(carry, k):
            xk, wk, fbuf, fcnt, ok, done, n_done, xout = carry
            active = jnp.logical_not(done)
            df, fx = grad(xk, mu)
            resid = jnp.linalg.norm(b - A(xk))

            yk = project(xk - df / Lmu, Lmu)
            apk = 0.5 * (k + 1.0)
            wk_n = wk + apk * df
            zk = project(xplug - wk_n / Lmu, Lmu)
            tauk = 2.0 / (k + 3.0)
            xk_n = tauk * zk + (1.0 - tauk) * yk

            fmean = jnp.sum(fbuf) / jnp.maximum(fcnt, 1.0)
            qp = jnp.abs(fx - fmean) / jnp.abs(fmean)
            trigger = qp <= tolv
            newly_done = jnp.logical_and(jnp.logical_and(trigger, ok), active)
            ok = jnp.where(active, jnp.logical_or(ok, trigger), ok)

            fbuf = jnp.where(active, jnp.roll(fbuf, 1).at[0].set(fx), fbuf)
            fcnt = jnp.where(active, jnp.minimum(fcnt + 1.0, 10.0), fcnt)

            keep = lambda a, o: jnp.where(active, a, o)
            xout = jnp.where(active, xk, xout)  # last active iterate
            carry = (
                keep(xk_n, xk), keep(wk_n, wk), fbuf, fcnt, ok,
                jnp.logical_or(done, newly_done),
                n_done + active.astype(jnp.int32), xout,
            )
            return carry, dict(fx=jnp.where(active, fx, 0.0),
                               resid=jnp.where(active, resid, 0.0))

        z = jnp.zeros_like(xplug)
        fbuf0 = jnp.full((10,), np.finfo(np.float32).tiny, dtype)
        init = (
            xplug, z, fbuf0, jnp.asarray(1.0, dtype), jnp.array(False),
            jnp.array(False), jnp.zeros((), jnp.int32), xplug,
        )
        (xk, _, _, _, _, _, n, xout), tr = jax.lax.scan(
            body, init, jnp.arange(max_iter, dtype=dtype)
        )
        return xout, n, tr

    inner_j = jax.jit(inner)

    mu = mu0
    tolv = 0.1
    xplug = x_plug
    objs, resids = [], []
    total = 0
    for _ in range(max_int_iter):
        mu = mu * gamma_c
        tolv = tolv * gamma_t
        xk, n, tr = inner_j(xplug, mu, tolv)
        n = int(n)
        objs.append(np.asarray(tr["fx"])[:n])
        resids.append(np.asarray(tr["resid"])[:n])
        total += n
        xplug = xk

    return NESTAResult(
        x=np.asarray(xplug),
        n_iters=total,
        objective=np.concatenate(objs),
        residual=np.concatenate(resids),
        mu_final=float(mu),
    )

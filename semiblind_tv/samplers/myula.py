"""MYULA — Moreau–Yosida regularised Unadjusted Langevin Algorithm.

One Langevin step (the reference inlines this in every SAPG loop —
SAPG/SAPG_algorithm_Guassian.m:160-162 — and ships a standalone variant in
SALSA/myula.m):

    X ← |X + γ (proxG(X, θ) − X)/λ − γ ∇f(X) + sqrt(2γ) Z|,   Z ~ N(0, I)

The abs() is the reference's positivity projection; proxG is evaluated at
the *previous* iterate (the prox is carried across steps), exactly like the
MATLAB loop which updates `proxGX` after the X update.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from semiblind_tv.ops.tv import chambolle_prox

__all__ = ["myula_kernel_step", "myula_sampler"]


def myula_kernel_step(x, prox_cache, grad_f, gamma, lam, noise, positivity: bool = True):
    """The pure MYULA update given a cached prox and a precomputed gradient.

    positivity=False gives the legacy Algorithm-1 sampler without the abs()
    projection (SALSA/SAPG_algorithm_1.m:173-174)."""
    xn = (
        x + gamma * (prox_cache - x) / lam - gamma * grad_f + jnp.sqrt(2.0 * gamma) * noise
    )
    return jnp.abs(xn) if positivity else xn


def myula_sampler(
    grad_f: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    key,
    n_steps: int,
    gamma,
    lam,
    theta,
    chambolle_iters: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Standalone fixed-hyperparameter MYULA chain (parity with SALSA/myula.m
    and the SAPG warm-up loop).  Returns (x_last, xs_mean)."""
    lam_theta = lam * theta
    prox0, _ = chambolle_prox(x0, lam_theta, chambolle_iters)

    def step(carry, k):
        x, prox_cache = carry
        z = jax.random.normal(k, x.shape, x.dtype)
        x = myula_kernel_step(x, prox_cache, grad_f(x), gamma, lam, z)
        prox_cache, _ = chambolle_prox(x, lam_theta, chambolle_iters)
        return (x, prox_cache), x

    keys = jax.random.split(key, n_steps)
    (x_last, _), xs = jax.lax.scan(step, (x0, prox0), keys)
    return x_last, jnp.mean(xs, axis=0)

"""Test-signal generators and operator-shape helpers (reference `SALSA/` legacy).

JAX re-implementations of the reference's small operator/test-signal
helpers used by the vendored solver zoo (SURVEY.md §2.2, last row):

  * `calctv`        — TV + max-gradient-magnitude of a vectorised image
                      (SALSA/calctv.m:1-7: zero-padded forward differences,
                      NOT the circular `conv2c` differences of TVnorm).
  * `monotonize`    — cumulative-offset monotone envelope of a 1-D trace
                      (SALSA/monotonize.m:1-16; used to monotonise objective
                      traces). O(n) scan in MATLAB → vectorised cumsum here.
  * `sparse_pws`    — L random n×n unit squares on an N×N canvas
                      (SALSA/sparsePWS.m:1-9), a sparse piecewise-smooth
                      test image for the L1/TV solvers.
  * `make_rd_squares` — NESTA's random-dynamic-range squares phantom
                      (SALSA/MakeRDSquares.m:1-31): nbs random rectangles
                      with amplitudes spanning `Dyna` dB, rescaled to
                      [1, 10^(Dyna/20)].
  * `vectorized_operator` — flatten/reshape adapter exposing an image-space
                      (A, Aᵀ) pair as a single mode-switched map on flat
                      vectors (SALSA/A_wrapper.m:1-18), for solvers written
                      against vectorised unknowns (SPGL1-style).
  * `ensure`        — assertion helper (SALSA/ensure.m:29-39).

Random generators take explicit `jax.random` keys (sharded-PRNG friendly)
instead of MATLAB's global `rand` stream; geometry/amplitude distributions
match the MATLAB math.  The per-operator call counters `wrapper_Acount.m` /
`wrapper_Atcount.m` are covered by `runtime.profiling.CallCounter`'s named
registry.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "calctv",
    "monotonize",
    "sparse_pws",
    "make_rd_squares",
    "vectorized_operator",
    "ensure",
]


def calctv(x: jnp.ndarray, shape: Tuple[int, int] | None = None):
    """(tv, max |∇|) with zero-padded forward differences (SALSA/calctv.m:4-6).

    `x` may be an (N1, N2) image or a flat vector plus `shape` — the MATLAB
    helper takes the vectorised image.  MATLAB reshapes column-major; for a
    flat input we honour that (order='F' semantics) so round-trips with
    `vectorized_operator` agree.
    """
    if x.ndim == 1:
        if shape is None:
            raise ValueError("flat input requires shape=(N1, N2)")
        n1, n2 = shape
        X = x.reshape((n2, n1)).T  # MATLAB reshape is column-major
    else:
        X = x
    dh = jnp.pad(jnp.diff(X, axis=1), ((0, 0), (0, 1)))  # [diff(X,1,2) zeros]
    dv = jnp.pad(jnp.diff(X, axis=0), ((0, 1), (0, 0)))  # [diff(X,1,1); zeros]
    mag = jnp.sqrt(dh**2 + dv**2)
    return jnp.sum(mag), jnp.max(mag)


def monotonize(x: jnp.ndarray) -> jnp.ndarray:
    """Non-decreasing envelope: lift each sample by the accumulated drops.

    MATLAB (SALSA/monotonize.m:8-16) loops, adding `x[k-1]-x[k]` to a running
    offset whenever the trace decreases; equivalent closed form:
    `y[k] = x[k] + Σ_{j≤k} max(0, x[j-1]-x[j])`.
    """
    x = jnp.asarray(x)
    drops = jnp.maximum(0.0, -jnp.diff(x))
    offset = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(drops)])
    return x + offset


def sparse_pws(key: jax.Array, N: int, L: int, n: int, corners=None) -> jnp.ndarray:
    """L random n×n unit squares on an N×N zero canvas (SALSA/sparsePWS.m:3-8).

    MATLAB draws `round(rand*N)` corners (0..N, clamped into the canvas);
    overlapping squares simply overwrite with 1.  Pass `corners` (L, 2)
    explicitly to pin the geometry (oracle tests).
    """
    if corners is None:
        corners = jnp.round(jax.random.uniform(key, (L, 2)) * N).astype(jnp.int32)
    else:
        corners = jnp.asarray(corners, jnp.int32)
    rows = jnp.arange(N)

    def paint(canvas, xc):
        r0 = jnp.maximum(xc[0], 1) - 1  # MATLAB 1-based max(xc,1)
        c0 = jnp.maximum(xc[1], 1) - 1
        rmask = (rows >= r0) & (rows <= jnp.minimum(xc[0] + n - 1, N) - 1)
        cmask = (rows >= c0) & (rows <= jnp.minimum(xc[1] + n - 1, N) - 1)
        return jnp.where(rmask[:, None] & cmask[None, :], 1.0, canvas), None

    canvas, _ = jax.lax.scan(paint, jnp.zeros((N, N)), corners)
    return canvas


def make_rd_squares(
    key: jax.Array, N: int = 256, nbs: int = 5, dyna: float = 40.0, draws=None
) -> jnp.ndarray:
    """Random rectangles spanning `dyna` dB of amplitude (SALSA/MakeRDSquares.m:17-31).

    nbs rectangles with side lengths in [8, N/4] and amplitudes
    `1 + 10^(dyna/20)·u`; afterwards the support (>0.5) is shifted/rescaled
    to exactly [1, 10^(dyna/20)].
    """
    lmin, lmax = 8, N // 4
    if draws is None:
        draws = jax.random.uniform(key, (nbs, 5))
    else:
        draws = jnp.asarray(draws)
    rows = jnp.arange(N)
    canvas = jnp.zeros((N, N))
    for u in draws:  # nbs is tiny and static — plain Python loop unrolls fine
        ndx = 1 + jnp.floor((N - lmax - 1) * u[0])
        lx = jnp.minimum(N - ndx - 1, jnp.floor(lmin + (lmax - lmin) * u[1]))
        ndy = 1 + jnp.floor((N - lmax - 1) * u[2])
        ly = jnp.minimum(N - ndy - 1, jnp.floor(lmin + (lmax - lmin) * u[3]))
        amp = 1.0 + 10.0 ** (dyna / 20.0) * u[4]
        rmask = (rows >= ndx - 1) & (rows <= ndx + lx - 2)
        cmask = (rows >= ndy - 1) & (rows <= ndy + ly - 2)
        canvas = jnp.where(rmask[:, None] & cmask[None, :], amp, canvas)
    supp = canvas > 0.5
    vals = jnp.where(supp, canvas, jnp.inf)
    vmin = jnp.min(vals)
    shifted = jnp.where(supp, canvas - vmin, 0.0)
    vmax = jnp.max(shifted)
    scale = jnp.where(vmax > 0, (10.0 ** (dyna / 20.0) - 1.0) / jnp.maximum(vmax, 1e-30), 0.0)
    return jnp.where(supp, shifted * scale + 1.0, 0.0)


def vectorized_operator(
    A: Callable, AT: Callable, in_shape: Tuple[int, int], out_shape: Tuple[int, int]
) -> Callable:
    """Mode-switched flat-vector adapter for an image-space (A, Aᵀ) pair.

    `op(x, mode)` with mode=1 applying A: R^{M1·N1} → R^{M2·N2} and mode=2
    applying Aᵀ the other way (SALSA/A_wrapper.m:6-18).  Column-major
    (MATLAB) flattening so vectorised solvers see the reference layout.
    """
    m1, n1 = in_shape
    m2, n2 = out_shape

    def op(x: jnp.ndarray, mode: int) -> jnp.ndarray:
        if mode == 1:
            xt = x.reshape((n1, m1)).T
            return A(xt).T.reshape(m2 * n2)
        if mode == 2:
            xt = x.reshape((n2, m2)).T
            return AT(xt).T.reshape(m1 * n1)
        raise ValueError("mode must be 1 (A) or 2 (AT)")

    return op


def ensure(condition, message: str = "Assertion failed") -> None:
    """Fail-fast precondition guard (SALSA/ensure.m:29-39)."""
    if not condition:
        raise AssertionError(message)

"""Spatial (row-block) sharding: halo-exchanged TV stencils + 2-D-decomposed
DFT transforms for images too large for one chip's HBM.

The reference processes whole images per-op (`fft2` over the full 512² array,
run_Gaussian_demo.m:136) and has no spatial decomposition anywhere; SURVEY §5
names this the framework's long-context analog ("optional: 2-D FFT
decomposition + halo-exchanged TV stencil for images ≫ HBM").  This module is
that capability:

  * The image's ROW axis is sharded over a 1-D ('space',) mesh
    (parallel.mesh.make_spatial_mesh) — each device holds a contiguous
    (M/S, N) row block.
  * **TV stencils** (Neumann divergence / forward gradient of
    chambolle_prox, circular differences of TVnorm) need exactly ONE row of
    halo per sweep in each direction; the halos ride `jax.lax.ppermute`
    over the mesh (neighbour exchange, O(N) bytes per sweep — the
    textbook stencil decomposition).
  * **rfft2 / irfft2** use the matmul-DFT formulation (ops/fourier.py::
    rdft_matrices): the row-transform is embarrassingly row-local, and the
    column-transform is a (M, M) contraction over the sharded axis —
    evaluated as a local partial matmul followed by `jax.lax.psum_scatter`
    (reduce-scatter), so the result stays row-sharded and the only
    cross-device traffic is the reduce-scatter itself.  No gather of the
    full image ever happens.
  * `spatial_salsa_tv` composes these into the complete SALSA MAP solve
    (prox + frequency LS step + Parseval objective + stop criterion) as ONE
    shard_map program over the mesh, numerically identical to
    solvers.salsa.salsa_tv (tested on the virtual CPU mesh).
  * `spatial_myula_step` is the row-sharded MYULA kernel (gradF through the
    sharded transforms + the halo-exchanged prox), the building block for a
    spatially-sharded sampler.

All functions take `axis_name` and run *inside* shard_map over a mesh with
that axis; `shard_rows`/`unshard_rows` are the host-side helpers that place
a global array onto the mesh and back.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from semiblind_tv.parallel.mesh import SPACE_AXIS

__all__ = [
    "shard_rows",
    "spatial_fft_precision",
    "spatial_tv_norm",
    "spatial_divergence",
    "spatial_forward_gradient",
    "spatial_chambolle_prox",
    "spatial_rfft2",
    "spatial_irfft2",
    "spatial_blur_apply",
    "spatial_salsa_tv",
    "spatial_myula_step",
    "run_sapg_spatial",
]


def shard_rows(x, mesh: Mesh, axis_name: str = SPACE_AXIS):
    """Place a global (M, N) array row-sharded onto the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name, None)))


def spatial_fft_precision(precision=None):
    """Per-apply transform matmul precision for the spatial path: HIGHEST
    unless given, the single-device policy (runtime/problem.
    resolve_fft_precision).  The OTF build (_spatial_otf) stays HIGHEST
    unconditionally: H feeds every gradient."""
    return jax.lax.Precision.HIGHEST if precision is None else precision


# ---------------------------------------------------------------------------
# Halo exchange primitives (inside shard_map)
# ---------------------------------------------------------------------------

def _row_from_above(x, axis_name):
    """Previous shard's LAST row (zeros on the first shard)."""
    S = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(S - 1)]
    return jax.lax.ppermute(x[-1:, :], axis_name, perm)


def _row_from_below(x, axis_name):
    """Next shard's FIRST row (zeros on the last shard)."""
    S = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(S - 1)]
    return jax.lax.ppermute(x[:1, :], axis_name, perm)


def _is_first(axis_name):
    return jax.lax.axis_index(axis_name) == 0


def _is_last(axis_name):
    return jax.lax.axis_index(axis_name) == jax.lax.axis_size(axis_name) - 1


# ---------------------------------------------------------------------------
# TV stencils with halos (semantics of ops/tv.py on the GLOBAL image)
# ---------------------------------------------------------------------------

def spatial_tv_norm(x, axis_name: str = SPACE_AXIS):
    """Circular-difference TV (utils/TVnorm.m) of the global image; the
    circular row shift wraps across shards via a circular ppermute."""
    S = jax.lax.axis_size(axis_name)
    above_c = jax.lax.ppermute(
        x[-1:, :], axis_name, [(i, (i + 1) % S) for i in range(S)]
    )
    xs = jnp.concatenate([above_c, x[:-1, :]], axis=0)
    dh = x - jnp.roll(x, 1, axis=1)
    dv = x - xs
    return jax.lax.psum(jnp.sum(jnp.sqrt(dh * dh + dv * dv)), axis_name)


def spatial_divergence(p1, p2, axis_name: str = SPACE_AXIS):
    """Neumann divergence (ops/tv.divergence) of row-sharded dual fields.

    Global row semantics: u[0] = p1[0]; u[i] = p1[i] − p1[i−1];
    u[M−1] = −p1[M−1].  The i−1 row of the first local row is the previous
    shard's last row; ppermute zero-fills shard 0, which IS the boundary
    condition (u[0] = p1[0] − 0)."""
    above = _row_from_above(p1, axis_name)
    u = p1 - jnp.concatenate([above, p1[:-1, :]], axis=0)
    last = jnp.where(_is_last(axis_name), -p1[-1, :], u[-1, :])
    u = u.at[-1, :].set(last)
    v = jnp.concatenate(
        [p2[:, :1], p2[:, 1:-1] - p2[:, :-2], -p2[:, -1:]], axis=1
    )
    return u + v


def spatial_forward_gradient(u, axis_name: str = SPACE_AXIS):
    """Forward differences, zero at the global last row/column
    (ops/tv.forward_gradient)."""
    below = _row_from_below(u, axis_name)
    dux = jnp.concatenate([u[1:, :], below], axis=0) - u
    dux = dux.at[-1, :].set(
        jnp.where(_is_last(axis_name), jnp.zeros_like(u[-1, :]), dux[-1, :])
    )
    duy = jnp.concatenate(
        [u[:, 1:] - u[:, :-1], jnp.zeros_like(u[:, :1])], axis=1
    )
    return dux, duy


def spatial_chambolle_prox(
    g,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    axis_name: str = SPACE_AXIS,
):
    """Halo-exchanged Chambolle dual ascent — identical math to
    ops/tv.chambolle_prox on the global image (masked fixed-trip early exit,
    warm-startable duals); per sweep: 2 one-row ppermutes + 1 scalar psum."""
    if duals is None:
        px = jnp.zeros_like(g)
        py = jnp.zeros_like(g)
    else:
        px, py = duals
    glam = g / lam

    def body(_, carry):
        px, py, k, err, active = carry
        u = spatial_divergence(px, py, axis_name) - glam
        upx, upy = spatial_forward_gradient(u, axis_name)
        tmp = jnp.sqrt(upx * upx + upy * upy)
        rx = -upx + tmp * px
        ry = -upy + tmp * py
        step_err = jnp.sqrt(
            jax.lax.psum(jnp.sum(rx * rx + ry * ry), axis_name)
        )
        denom = 1.0 + tau * tmp
        px = jnp.where(active, (px + tau * upx) / denom, px)
        py = jnp.where(active, (py + tau * upy) / denom, py)
        err = jnp.where(active, step_err, err)
        k = k + active.astype(k.dtype)
        active = jnp.logical_and(active, step_err > tol)
        return px, py, k, err, active

    init = (
        px, py, jnp.zeros((), jnp.int32), jnp.array(jnp.inf, g.dtype),
        jnp.array(True),
    )
    px, py, k, err, _ = jax.lax.fori_loop(0, max_iter, body, init)
    f = g - lam * spatial_divergence(px, py, axis_name)
    return f, (px, py, k, err)


# ---------------------------------------------------------------------------
# Row-sharded matmul-DFT transforms (reduce-scatter column contraction)
# ---------------------------------------------------------------------------

def _local_cols(mat, rows_local, axis_name):
    """This shard's (M, M/S) column slice of a full (M, M) factor matrix."""
    idx = jax.lax.axis_index(axis_name)
    return jax.lax.dynamic_slice(
        mat,
        (jnp.zeros((), idx.dtype), idx * jnp.asarray(rows_local, idx.dtype)),
        (mat.shape[0], rows_local),
    )


def spatial_rfft2(x, mats, axis_name: str = SPACE_AXIS, precision=None):
    """rfft2 of a row-sharded real image → row-sharded half-spectrum
    (re, im).  Row transform is local; the (M, M) column contraction is a
    local partial matmul + psum_scatter (reduce-scatter over the mesh)."""
    hp = spatial_fft_precision(precision)
    CN, SN, CM, SM = (jnp.asarray(mats[k], x.dtype) for k in ("CN", "SN", "CM", "SM"))
    Ml = x.shape[0]
    yre = jnp.matmul(x, CN, precision=hp)
    yim = -jnp.matmul(x, SN, precision=hp)
    CMl = _local_cols(CM, Ml, axis_name)
    SMl = _local_cols(SM, Ml, axis_name)
    zre_part = jnp.matmul(CMl, yre, precision=hp) + jnp.matmul(SMl, yim, precision=hp)
    zim_part = jnp.matmul(CMl, yim, precision=hp) - jnp.matmul(SMl, yre, precision=hp)
    zre = jax.lax.psum_scatter(zre_part, axis_name, scatter_dimension=0, tiled=True)
    zim = jax.lax.psum_scatter(zim_part, axis_name, scatter_dimension=0, tiled=True)
    return zre, zim


def spatial_irfft2(zre, zim, mats, axis_name: str = SPACE_AXIS, precision=None):
    """irfft2 of a row-sharded half-spectrum (re, im) → row-sharded real
    image.  Column contraction first (partial matmul + reduce-scatter),
    then the local hermitian-weighted row transform."""
    hp = spatial_fft_precision(precision)
    CM, SM, WCT, WST = (
        jnp.asarray(mats[k], zre.dtype) for k in ("CM", "SM", "WCT", "WST")
    )
    M = CM.shape[0]
    Ml = zre.shape[0]
    CMl = _local_cols(CM, Ml, axis_name)
    SMl = _local_cols(SM, Ml, axis_name)
    yre_part = jnp.matmul(CMl, zre, precision=hp) - jnp.matmul(SMl, zim, precision=hp)
    yim_part = jnp.matmul(CMl, zim, precision=hp) + jnp.matmul(SMl, zre, precision=hp)
    yre = jax.lax.psum_scatter(yre_part, axis_name, scatter_dimension=0, tiled=True) / M
    yim = jax.lax.psum_scatter(yim_part, axis_name, scatter_dimension=0, tiled=True) / M
    return jnp.matmul(yre, WCT, precision=hp) - jnp.matmul(yim, WST, precision=hp)


def spatial_blur_apply(x, Hre, Him, mats, axis_name: str = SPACE_AXIS,
                       adjoint=False, precision=None):
    """A x (or Aᵀ x) for a row-sharded image and row-sharded OTF planes."""
    precision = spatial_fft_precision(precision)
    zre, zim = spatial_rfft2(x, mats, axis_name, precision=precision)
    if adjoint:
        re = Hre * zre + Him * zim
        im = Hre * zim - Him * zre
    else:
        re = Hre * zre - Him * zim
        im = Hre * zim + Him * zre
    return spatial_irfft2(re, im, mats, axis_name, precision=precision)


# ---------------------------------------------------------------------------
# Row-sharded MYULA kernel step
# ---------------------------------------------------------------------------

def spatial_myula_step(
    x, prox, z, Hre, Him, yhre, yhim, mats, gamma, lam, sigma2,
    axis_name: str = SPACE_AXIS, positivity: bool = True, precision=None,
):
    """One MYULA Langevin update of a row-sharded chain state
    (samplers/myula.py semantics; gradF through the sharded transforms)."""
    precision = spatial_fft_precision(precision)
    zre, zim = spatial_rfft2(x, mats, axis_name, precision=precision)
    rre = Hre * zre - Him * zim - yhre
    rim = Hre * zim + Him * zre - yhim
    gre = Hre * rre + Him * rim
    gim = Hre * rim - Him * rre
    gradF = spatial_irfft2(gre, gim, mats, axis_name, precision=precision) / sigma2
    xn = x + gamma * (prox - x) / lam - gamma * gradF + jnp.sqrt(2.0 * gamma) * z
    return jnp.abs(xn) if positivity else xn


# ---------------------------------------------------------------------------
# Spatially-sharded SALSA MAP solve (one shard_map program)
# ---------------------------------------------------------------------------

def spatial_salsa_tv(
    y,
    H,
    tau,
    mu,
    mesh: Mesh,
    max_iter: int = 500,
    tol: float = 1e-5,
    tv_iters: int = 10,
    dtype=jnp.float32,
    chambolle_tau: float = 0.249,
    chambolle_tol: float = 1e-3,
):
    """Row-sharded SALSA (solvers/salsa.salsa_tv semantics, stop criterion 1)
    over a ('space',) mesh.  Returns (x, objective trace, n_iters).

    y: global (M, N) observation; H: host NumPy full OTF (M, N//2+1).
    Numerically identical to the single-device solve: the prox exchanges
    one-row halos per sweep, the LS step runs through the reduce-scattered
    matmul-DFTs, and the objective/stop test psum-reduces two scalars per
    outer iteration.
    """
    from semiblind_tv.ops.fourier import rdft_matrices, rfft_weights

    axis = mesh.axis_names[0]
    M, N = y.shape
    d = M * N
    H = np.asarray(H)
    prec = spatial_fft_precision()
    mats = {k: v for k, v in rdft_matrices((M, N), dtype).items()}
    w_full = np.asarray(rfft_weights((M, N), dtype))  # (1, Nh) column weights

    y_sh = shard_rows(jnp.asarray(y, dtype), mesh, axis)
    Hre = shard_rows(jnp.asarray(H.real, dtype), mesh, axis)
    Him = shard_rows(jnp.asarray(H.imag, dtype), mesh, axis)
    tau = jnp.asarray(tau, dtype)
    mu = jnp.asarray(mu, dtype)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(), P()),
        out_specs=(P(axis, None), P(), P()),
    )
    def solve(y_l, Hre_l, Him_l, tau, mu):
        yhre, yhim = spatial_rfft2(y_l, mats, axis, precision=prec)
        ATy_re = Hre_l * yhre + Him_l * yhim
        ATy_im = Hre_l * yhim - Him_l * yhre
        inv_f = 1.0 / (Hre_l * Hre_l + Him_l * Him_l + mu)
        thresh = tau / mu
        w = jnp.asarray(w_full, dtype)

        def pnorm2(re, im):
            return jax.lax.psum(jnp.sum(w * (re * re + im * im)), axis) / d

        def body(carry, k):
            x, u, bu, pux, puy, prev_obj, done, n_done = carry
            active = jnp.logical_not(done)
            un, (pxn, pyn, _, _) = spatial_chambolle_prox(
                x - bu, thresh, tv_iters, tau=chambolle_tau,
                tol=chambolle_tol, duals=(pux, puy), axis_name=axis,
            )
            rre, rim = spatial_rfft2(un + bu, mats, axis, precision=prec)
            xh_re = inv_f * (ATy_re + mu * rre)
            xh_im = inv_f * (ATy_im + mu * rim)
            xn = spatial_irfft2(xh_re, xh_im, mats, axis, precision=prec)
            bun = bu + (un - xn)

            res_re = yhre - (Hre_l * xh_re - Him_l * xh_im)
            res_im = yhim - (Hre_l * xh_im + Him_l * xh_re)
            obj = 0.5 * pnorm2(res_re, res_im) + tau * spatial_tv_norm(un, axis)
            crit = jnp.abs(obj - prev_obj) / prev_obj
            newly = jnp.logical_and(jnp.logical_and(crit < tol, k >= 1), active)

            keep = lambda a, b: jnp.where(active, a, b)
            carry = (
                keep(xn, x), keep(un, u), keep(bun, bu),
                keep(pxn, pux), keep(pyn, puy),
                jnp.where(active, obj, prev_obj),
                jnp.logical_or(done, newly),
                n_done + active.astype(jnp.int32),
            )
            return carry, jnp.where(active, obj, prev_obj)

        x0 = jnp.zeros_like(y_l)
        obj0 = 0.5 * jax.lax.psum(jnp.sum(y_l * y_l), axis)
        init = (
            x0, x0, x0, x0, x0, obj0.astype(dtype),
            jnp.array(False), jnp.zeros((), jnp.int32),
        )
        (x, *_r, n_done), objs = jax.lax.scan(body, init, jnp.arange(max_iter))
        return x, objs, n_done

    x, objs, n_done = solve(y_sh, Hre, Him, tau, mu)
    return x, np.asarray(objs), int(n_done)


# ---------------------------------------------------------------------------
# Full spatially-sharded SAPG estimator (single chain, giant-image mode)
# ---------------------------------------------------------------------------

def _spatial_otf(kernel, Fx, Fy, rows_local, axis_name):
    """This shard's rows of the corner-embedded OTF (re, im).

    Row r of the full OTF is (Fxᵀ k Fy)[r] (ops/fourier.otf_rfft); slicing
    Fx's columns to the shard's rows before the matmuls keeps the work and
    memory O(M/S) per device — the OTF is never materialised globally.
    """
    hp = jax.lax.Precision.HIGHEST
    idx = jax.lax.axis_index(axis_name)
    Fxl = jax.lax.dynamic_slice(
        Fx,
        (jnp.zeros((), idx.dtype), idx * jnp.asarray(rows_local, idx.dtype)),
        (Fx.shape[0], rows_local),
    )
    left = jnp.matmul(Fxl.T, kernel.astype(Fxl.dtype), precision=hp)
    H = jnp.matmul(left, Fy, precision=hp)
    return H.real, H.imag


def run_sapg_spatial(
    problem, mesh: Mesh, key, x0=None,
    checkpoint_every=None, checkpoint_path=None, checkpoint_backend="npz",
    nan_guard=True, max_restores=1, fault_hook=None,
):
    """Warm-up + SAPG + EB extraction with the IMAGE row-sharded over a
    ('space',) mesh — the giant-image estimator (one Markov chain whose
    state never fits, or never needs to fit, on one chip).

    Math and iteration order mirror sapg/estimator.py exactly; per
    iteration the cross-device traffic is 4 reduce-scatters (the two
    transforms), two one-row halos per prox sweep, and the psum'd scalar
    statistics.  The MYULA noise is drawn replicated from the same
    key-split sequence as the single-device estimator and row-sliced, so
    the trajectory matches `run_sapg(problem, key, n_chains=1)` to
    reduction-order rounding (tested at f64).  Returns the full
    `SAPGResult` diagnostics bundle via the shared `assemble_result`.
    """
    from semiblind_tv.ops.fourier import rdft_matrices, rfft_weights
    from semiblind_tv.sapg.estimator import assemble_result

    cfg = problem.cfg
    sapg = cfg.sapg
    blur = problem.blur
    dtype = blur.dtype
    M, N = blur.shape
    d = blur.dim
    axis = mesh.axis_names[0]
    S = mesh.devices.size
    Ml = M // S
    assert M % S == 0, f"rows {M} not divisible by mesh size {S}"

    model = problem.model
    theta_spec = cfg.theta
    psf_specs = cfg.psf_params
    psf_names = tuple(s.name for s in psf_specs)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    sigma_spec = problem.sigma_spec()
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / theta_spec.init
    prec = spatial_fft_precision()
    mats = rdft_matrices((M, N), dtype)
    w_full = np.asarray(rfft_weights((M, N), dtype))
    Fx, Fy = blur.factors  # host numpy complex factor matrices

    theta0 = jnp.asarray(theta_spec.init, dtype)
    sigma0 = jnp.asarray(problem.sigma2_init, dtype)
    params0 = {k: jnp.asarray(v, dtype) for k, v in cfg.init_psf_params().items()}
    gam = jnp.asarray(problem.gamma, dtype)
    lam = jnp.asarray(problem.lambda_myula, dtype)
    s2_lo = jnp.asarray(problem.sigma2_box[0], dtype)
    s2_hi = jnp.asarray(problem.sigma2_box[1], dtype)

    n_warm = max(sapg.warmup - 1, 0)
    if x0 is None:
        x0 = problem.y
    y_sh = shard_rows(jnp.asarray(x0, dtype), mesh, axis)

    H0_full = blur.otf_host(model.kernel(params0))  # host (M, Nh) constant

    def local_slice(full):
        """Shard's rows of a host-side (M, ...) constant (closure capture)."""
        def inner(arr):
            idx = jax.lax.axis_index(axis)
            return jax.lax.dynamic_slice(
                arr,
                (idx * jnp.asarray(Ml, idx.dtype),)
                + tuple(jnp.zeros((), idx.dtype) for _ in arr.shape[1:]),
                (Ml,) + arr.shape[1:],
            )
        return inner(jnp.asarray(full))

    def spatial_prox(Xl, lam_theta):
        f, _ = spatial_chambolle_prox(
            Xl, lam_theta, sapg.chambolle_iters,
            tau=sapg.chambolle_tau, tol=sapg.chambolle_tol, axis_name=axis,
        )
        return f

    def draw_noise(key_c):
        """Same split/draw sequence as estimator.chain_noise at 1 chain,
        sliced to this shard's rows (replicated draw, exact parity)."""
        ks = jax.random.split(key_c)
        Z_full = jax.random.normal(ks[1], (M, N), dtype)
        return ks[0], local_slice(Z_full)

    def pnorm2(re, im, w):
        return jax.lax.psum(jnp.sum(w * (re * re + im * im)), axis) / d

    def pdot(are, aim, bre, bim, w):
        return jax.lax.psum(jnp.sum(w * (are * bre + aim * bim)), axis) / d

    def otfs_local(params):
        k, dks = model.kernel_and_grads(params)
        H = _spatial_otf(k, jnp.asarray(Fx), jnp.asarray(Fy), Ml, axis)
        dHs = {
            n: _spatial_otf(dks[n], jnp.asarray(Fx), jnp.asarray(Fy), Ml, axis)
            for n in free_names
        }
        return H, dHs

    carry_specs = (
        P(axis, None), P(axis, None), P(axis, None), P(axis, None),
        P(), P(), P(), {s.name: P() for s in psf_specs},
    )
    trace_specs = {k: P() for k in _trace_keys(psf_names)}

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(carry_specs, P(), P()),
    )
    def warm_all(y_l, key_c):
        w = jnp.asarray(w_full, dtype)
        yh_re, yh_im = spatial_rfft2(y_l, mats, axis, precision=prec)
        H0re = local_slice(np.ascontiguousarray(H0_full.real))
        H0im = local_slice(np.ascontiguousarray(H0_full.imag))

        prox0 = spatial_prox(y_l, lam * theta0)
        Xh_re0, Xh_im0 = spatial_rfft2(y_l, mats, axis, precision=prec)

        def warm_step(carry, _):
            Xl, Xre, Xim, prox, key_c = carry
            rre = H0re * Xre - H0im * Xim - yh_re
            rim = H0re * Xim + H0im * Xre - yh_im
            gre = H0re * rre + H0im * rim
            gim = H0re * rim - H0im * rre
            gradF = spatial_irfft2(gre, gim, mats, axis, precision=prec) / sigma0
            key_c, Z = draw_noise(key_c)
            Xn = Xl + gam * (prox - Xl) / lam - gam * gradF + jnp.sqrt(2.0 * gam) * Z
            Xn = jnp.abs(Xn)
            proxn = spatial_prox(Xn, lam * theta0)
            Xre_n, Xim_n = spatial_rfft2(Xn, mats, axis, precision=prec)
            res2 = pnorm2(H0re * Xre_n - H0im * Xim_n - yh_re,
                          H0re * Xim_n + H0im * Xre_n - yh_im, w)
            logpi = -res2 / (2.0 * sigma0) - theta0 * spatial_tv_norm(Xn, axis)
            return (Xn, Xre_n, Xim_n, proxn, key_c), logpi

        carry0 = (y_l, Xh_re0, Xh_im0, prox0, key_c)
        if n_warm > 0:
            carry0, logpi_wu = jax.lax.scan(warm_step, carry0, None, length=n_warm)
        else:
            logpi_wu = jnp.zeros((0,), dtype)
        Xl, Xre, Xim, prox, key_c = carry0
        res2_0 = pnorm2(H0re * Xre - H0im * Xim - yh_re,
                        H0re * Xim + H0im * Xre - yh_im, w)
        logpi0 = -res2_0 / (2.0 * sigma0) - theta0 * spatial_tv_norm(Xl, axis)
        carry = (Xl, Xre, Xim, prox, key_c, theta0, sigma0, params0)
        return carry, logpi_wu, logpi0

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(carry_specs, (P(axis, None), P(axis, None)), P()),
        out_specs=(carry_specs, trace_specs),
    )
    def main_seg(carry, yh, iis):
        w = jnp.asarray(w_full, dtype)
        yh_re, yh_im = yh

        def step(carry, ii):
            Xl, Xre, Xim, prox, key_c, theta, sigma2, params = carry
            (Hre, Him), dHs = otfs_local(params)
            rre = Hre * Xre - Him * Xim - yh_re
            rim = Hre * Xim + Him * Xre - yh_im
            gre = Hre * rre + Him * rim
            gim = Hre * rim - Him * rre
            gradF = spatial_irfft2(gre, gim, mats, axis, precision=prec) / sigma2
            key_c, Z = draw_noise(key_c)
            Xn = Xl + gam * (prox - Xl) / lam - gam * gradF + jnp.sqrt(2.0 * gam) * Z
            if sapg.positivity:
                Xn = jnp.abs(Xn)
            proxn = spatial_prox(Xn, lam * theta)
            Xre_n, Xim_n = spatial_rfft2(Xn, mats, axis, precision=prec)
            Rre = Hre * Xre_n - Him * Xim_n - yh_re
            Rim = Hre * Xim_n + Him * Xre_n - yh_im
            res2 = pnorm2(Rre, Rim, w)
            tv = spatial_tv_norm(Xn, axis)

            G_t = d / theta - tv
            G_s = res2 / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2)
            G_p = {}
            for n in free_names:
                dre, dim_ = dHs[n]
                G_p[n] = pdot(
                    dre * Xre_n - dim_ * Xim_n, dre * Xim_n + dim_ * Xre_n,
                    Rre, Rim, w,
                ) / sigma2
            zero = jnp.zeros_like(G_t)

            delta_i = d_scale * ii.astype(dtype) ** (-sapg.d_exp) / d
            theta_n = theta_spec.clip(theta + theta_spec.step_scale * delta_i * G_t)
            params_n = {}
            for s in psf_specs:
                if s.fix:
                    cand = jnp.asarray(s.true_value, dtype)
                else:
                    cand = params[s.name] + s.sign * s.step_scale * delta_i * G_p[s.name]
                params_n[s.name] = s.clip(cand)
            if sigma_spec.fix:
                sigma_n = sigma0
            else:
                sigma_n = jnp.clip(
                    sigma2 + cfg.sigma_step_scale * delta_i * G_s, s2_lo, s2_hi
                )
            logpi = -res2 / (2.0 * sigma2) - theta * tv
            trace = dict(
                theta=theta_n, sigma2=sigma_n, logPi=logpi, gX=tv,
                G_t=G_t, G_s=G_s,
                **{f"G_{n}": G_p.get(n, zero) for n in psf_names},
                **{n: params_n[n] for n in psf_names},
            )
            return (Xn, Xre_n, Xim_n, proxn, key_c, theta_n, sigma_n, params_n), trace

        return jax.lax.scan(step, carry, iis.astype(dtype))

    import os as _os
    import time as _time

    from semiblind_tv.runtime.checkpoint import (
        load_checkpoint_arrays, save_checkpoint_arrays,
    )
    from semiblind_tv.sapg.estimator import run_segmented_scan

    # same per-chain key derivation as the single-device estimator at
    # n_chains=1 (run_sapg: keys = jax.random.split(key, n_chains))
    key0 = jax.random.split(key, 1)[0]

    rfft_y = jax.jit(
        jax.shard_map(
            lambda y_l: spatial_rfft2(y_l, mats, axis, precision=prec),
            mesh=mesh, in_specs=(P(axis, None),),
            out_specs=(P(axis, None), P(axis, None)),
        )
    )
    yh = rfft_y(y_sh)

    def _reshard(arr):
        return shard_rows(jnp.asarray(arr), mesh, axis)

    def _save(path, carry, done, segs, logpi_wu, logpi0):
        Xl, Xre, Xim, prox, key_c, theta, sigma2, params = carry
        merged = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *segs)
        arrays = {f"trace/{k}": v for k, v in merged.items()}
        arrays.update(
            X=np.asarray(Xl), Xre=np.asarray(Xre), Xim=np.asarray(Xim),
            prox=np.asarray(prox),
            keys=np.asarray(jax.random.key_data(key_c)),
            theta=np.asarray(theta), sigma2=np.asarray(sigma2),
            done_iters=np.asarray(done),
            logpi_wu=np.asarray(logpi_wu), logpi0=np.asarray(logpi0),
        )
        for k, v in params.items():
            arrays[f"param/{k}"] = np.asarray(v)
        save_checkpoint_arrays(path, arrays, backend=checkpoint_backend)

    logpi_state = {}

    def _restore():
        z = load_checkpoint_arrays(checkpoint_path, backend=checkpoint_backend)
        params = {k[len("param/"):]: jnp.asarray(z[k], dtype)
                  for k in z if k.startswith("param/")}
        carry = (
            _reshard(z["X"]), _reshard(z["Xre"]), _reshard(z["Xim"]),
            _reshard(z["prox"]),
            jax.random.wrap_key_data(jnp.asarray(z["keys"])),
            jnp.asarray(z["theta"], dtype), jnp.asarray(z["sigma2"], dtype),
            params,
        )
        traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
        logpi_state["wu"] = z["logpi_wu"]
        logpi_state["0"] = z["logpi0"]
        return carry, int(z["done_iters"]), [traces]

    t0 = _time.perf_counter()
    resume = checkpoint_path is not None and _os.path.exists(checkpoint_path)
    if resume:
        carry0 = logpi_wu = logpi0 = None
    else:
        carry0, logpi_wu, logpi0 = jax.jit(warm_all)(y_sh, key0)

    seg = jax.jit(lambda c, iis: main_seg(c, yh, iis))
    carry, seg_traces = run_segmented_scan(
        seg, carry0, sapg.samples,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path,
        save_fn=lambda c, done, segs: _save(
            checkpoint_path, c, done, segs,
            logpi_state.get("wu", logpi_wu), logpi_state.get("0", logpi0),
        ),
        restore_fn=_restore,
        fault_hook=fault_hook,
        nan_guard=nan_guard,
        max_restores=max_restores,
    )
    if resume or "wu" in logpi_state:
        logpi_wu, logpi0 = logpi_state["wu"], logpi_state["0"]
    traces = (
        jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *seg_traces)
        if len(seg_traces) > 1 else seg_traces[0]
    )
    X_last = carry[0]
    jax.block_until_ready(X_last)
    exec_time = _time.perf_counter() - t0

    traces = jax.tree_util.tree_map(np.asarray, traces)
    return assemble_result(
        problem, psf_names, traces,
        np.asarray(logpi_wu) if n_warm > 0 else np.zeros(0),
        float(logpi0),
        np.asarray(X_last)[None],  # (1, M, N): single spatial chain
        {},
        exec_time,
    )


def _trace_keys(psf_names):
    keys = ["theta", "sigma2", "logPi", "gX", "G_t", "G_s"]
    keys += [f"G_{n}" for n in psf_names]
    keys += list(psf_names)
    return keys

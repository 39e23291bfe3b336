#!/usr/bin/env python3
"""Smoke run of the semi-blind TV deblurring path on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-5 on one card
    python chip_smoke.py --bands    # phases 0-5, then the full-budget gates
    python chip_smoke.py --four     # only the four-card mesh phases

Phases: 0 device check; 1 the main path (`run_demo.main`: synthesis, SAPG
warm-up and main scan, SALSA MAP, metrics) on wheel.png at 512², 7×7
Gaussian PSF, BSNR 30 — the reference's `run_Gaussian_demo.m` experiment at
a short budget; 2 the Laplace and Moffat families with 4 chains;
3 correctness on the card against the f64 NumPy oracles (tests/oracles.py)
and against the same program on `jax.devices("cpu")`; 4 the 2048² size
rung; 5 informational timings (smoke readings, not benchmark cells).

Every phase prints one line naming the card and its power limit.  The last
line of standard output is one JSON object, {"ok": true, "device": {...}},
printed only when every phase passed.  With no GPU the script exits
non-zero before doing any work.  Everything runs in this one process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.cli import run_demo
from semiblind_tv.ops.fourier import BlurOperator
from semiblind_tv.ops.psf import gaussian_kernel
from semiblind_tv.ops.tv import chambolle_prox
from semiblind_tv.parallel.mesh import make_mesh, make_spatial_mesh
from semiblind_tv.parallel.spatial import run_sapg_spatial
from semiblind_tv.runtime import build_problem, preset
from semiblind_tv.runtime.cache import enable_persistent_cache
from semiblind_tv.sapg import run_sapg
from semiblind_tv.sapg.estimator import make_sapg_step
from semiblind_tv.solvers import salsa_tv
from semiblind_tv.utils import load_image, synthetic_wheel
from tests import oracles

F32 = jnp.float32

# Tolerances of f32 results on the card, as relative max-abs errors
# (max |got − want| / max |want|).  Why the two sides differ at all:
#  * against the f64 NumPy oracles: f32 rounding (ε ≈ 6e-8) of every
#    operation, accumulated over the 25 prox sweeps and the iterations;
#  * cuFFT f32 is not the CPU's FFT, so every transform differs at f32
#    rounding between the card and the CPU;
#  * reductions (the prox residual, Parseval sums, TV) run in a different
#    order on the GPU;
#  * no f32 matmul of these paths runs in TF32: the OTF matmuls pin
#    Precision.HIGHEST and fft_mode="fft" has no transform matmuls.
# Each bound is well above what f32 reaches against f64 on the CPU at the
# same shapes; adding 1e-3 to the prox's dual-step denominator already
# fails each of the prox, SALSA and SAPG checks at 64².
TOL = {
    # prox output after 25 sweeps (fresh and warm duals)
    "prox": 1e-5,
    # its dual fields (|p| <= 1): a dual is ill-conditioned where |∇u| sits
    # at the rounding level of u ≈ g/λ, and f = g − λ·div p damps that by λ
    # (f32 on the CPU reaches 3e-4 at 512²)
    "prox_duals": 5e-3,
    # SALSA iterate after 50 warm-dual outer iterations: errors of the
    # rfft-diagonal LS step and the prox compound across iterations
    "salsa": 1e-4,
    # SAPG carry (sample, prox, θ, w1, w2, σ²) after 5 steps; the card
    # against the CPU is held to the same bound as both against the oracle
    "sapg": 2e-5,
    # θ/σ²/PSF traces and the last samples of a short run, sharded vs one
    # device: same keys, reductions over chains or rows in another order
    "mesh": 1e-3,
}

CARD = "no card"


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def report(phase, name: str, detail: str) -> None:
    print(f"phase {phase} {name} [{CARD}]: {detail}", flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _test_image(size: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return synthetic_wheel(size) + 5.0 * rng.standard_normal((size, size))


# ---------------------------------------------------------------------------
# Phase 1/2: the main path through run_demo.main
# ---------------------------------------------------------------------------

def demo(psf: str, size: int, samples: int, warmup: int, chains: int) -> dict:
    """One `run_demo.main` call; checks the EB estimates and the MAP gain."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run_demo.main([
            "--psf", psf, "--image", "wheel", "--size", str(size),
            "--samples", str(samples), "--warmup", str(warmup),
            "--chains", str(chains),
        ])
    est = [res["theta_EB"], res["sigma2_EB"], *res["psf_params_EB"].values()]
    require(all(np.isfinite(est)), f"{psf}: non-finite EB estimate {est}")
    require(res["mse_db"] < res["mse_db_observation"],
            f"{psf}: MAP mse {res['mse_db']} dB not below the observation's "
            f"{res['mse_db_observation']} dB")
    return res


# ---------------------------------------------------------------------------
# Phase 3: correctness against the oracles and the CPU
# ---------------------------------------------------------------------------

def check_prox(size: int, device, lam: float = 0.05, sweeps: int = 25) -> dict:
    """XLA `chambolle_prox` in f32 on `device` against `np_chambolle` (f64),
    with fresh duals and then with the first solve's duals as warm start.

    tol=0 fixes the sweep count: the f32 residual has a rounding floor of
    about ε·|g/λ|·√(MN), above SAPG's 1e-3 tol at these shapes, while the
    f64 residual can cross it; the early exit itself is tested on the CPU."""
    g = _test_image(size)
    with jax.default_device(device):
        g32 = jnp.asarray(g, F32)
        f1, s1 = chambolle_prox(g32, lam, sweeps, tol=0.0)
        f2, s2 = chambolle_prox(g32, lam, sweeps, tol=0.0, duals=(s1.px, s1.py))
    g = np.asarray(g32, np.float64)
    of1, opx1, opy1, ok1, _ = oracles.np_chambolle(g, lam, sweeps, tol=0.0)
    of2, opx2, opy2, ok2, _ = oracles.np_chambolle(g, lam, sweeps, tol=0.0,
                                                   duals=(opx1, opy1))
    errs = {
        "fresh_f": rel_err(f1, of1), "fresh_px": rel_err(s1.px, opx1),
        "fresh_py": rel_err(s1.py, opy1),
        "warm_f": rel_err(f2, of2), "warm_px": rel_err(s2.px, opx2),
        "warm_py": rel_err(s2.py, opy2),
    }
    require(int(s1.iters) == ok1 and int(s2.iters) == ok2,
            f"prox sweeps {int(s1.iters)},{int(s2.iters)} != oracle {ok1},{ok2}")
    for k, v in errs.items():
        tol = TOL["prox"] if k.endswith("_f") else TOL["prox_duals"]
        require(v < tol, f"prox {k} error {v:.3g} >= {tol}")
    return errs


def check_salsa(size: int, device, iters: int = 50) -> dict:
    """`salsa_tv` in f32 on `device` against `np_salsa` (f64) for a fixed
    number of outer iterations (tol=0 never stops either side early)."""
    rng = np.random.default_rng(1)
    x = synthetic_wheel(size)
    k64 = oracles.np_gaussian_kernel(7, 0.4, 0.3)
    H64 = oracles.np_otf(k64, (size, size))
    y = oracles.np_blur(x, H64) + 2.0 * rng.standard_normal((size, size))
    y = np.asarray(np.asarray(y, np.float32), np.float64)
    tau, mu = 0.03 * 4.0, 0.03 * 0.1  # θ·σ², θ·mu_factor at θ=0.03, σ²=4
    blur = BlurOperator((size, size), 7, F32)
    with jax.default_device(device):
        H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=F32))
        got = salsa_tv(jnp.asarray(y, F32), H, tau, mu, blur,
                       max_iter=iters, tol=0.0, tv_iters=10)
    want = oracles.np_salsa(y, H64, tau, mu, max_iter=iters, tol=0.0, tv_iters=10)
    require(got.n_iters == want["n_iters"] == iters,
            f"salsa ran {got.n_iters} / oracle {want['n_iters']} of {iters}")
    errs = {"x": rel_err(got.x, want["x"]),
            "objective": rel_err(got.objective, want["objective"])}
    for k, v in errs.items():
        require(v < TOL["salsa"], f"salsa {k} error {v:.3g} >= {TOL['salsa']}")
    return errs


def initial_carry(problem, aux, n_chains: int, key):
    """The SAPG carry at the warm start X = y, as run_sapg builds it."""
    cfg = problem.cfg
    dt = problem.blur.dtype
    theta0 = jnp.asarray(cfg.theta.init, dt)
    params0 = {k: jnp.asarray(v, dt) for k, v in cfg.init_psf_params().items()}
    X0 = jnp.broadcast_to(jnp.asarray(problem.y, dt),
                          (n_chains,) + tuple(problem.blur.shape))
    prox0, _ = aux["prox_b"](X0, aux["lam"] * theta0)
    Xhat0 = jax.jit(problem.blur.rfft)(X0)
    keys = jax.random.split(key, n_chains)
    sigma0 = jnp.asarray(problem.sigma2_init, dt)
    return (X0, Xhat0, prox0, keys, theta0, sigma0, params0, {})


def _gaussian_free_w():
    return preset("gaussian", fix_w1=False, fix_w2=False)


def sapg_steps(size: int, n_steps: int, device) -> tuple:
    """`n_steps` SAPG steps (Gaussian, w1/w2 estimated) in f32 on `device`;
    returns (problem, host copy of the carry's sample/prox/θ/σ²/params)."""
    cfg = _gaussian_free_w()
    with jax.default_device(device):
        problem = build_problem(synthetic_wheel(size), cfg, jax.random.key(7), dtype=F32)
        step, aux = make_sapg_step(problem, n_chains=1)
        carry = initial_carry(problem, aux, 1, jax.random.key(3))
        iis = jnp.arange(2, n_steps + 2, dtype=F32)
        carry, _ = jax.jit(lambda c, i: jax.lax.scan(step, c, i))(carry, iis)
    X, _, prox, _, theta, sigma2, params, _ = carry
    out = dict(X=X[0], prox=prox[0], theta=theta, sigma2=sigma2, **params)
    return problem, {k: np.asarray(v, np.float64) for k, v in out.items()}


def oracle_sapg_steps(problem, n_steps: int) -> dict:
    """The same steps with `np_sapg_gaussian_step` (f64) from the problem's
    y and constants, drawing the identical per-chain noise."""
    cfg = problem.cfg
    sapg = cfg.sapg
    specs = {s.name: s for s in cfg.psf_params}
    y = np.asarray(problem.y, np.float64)
    theta = cfg.theta.init
    w1, w2 = cfg.init_psf_params()["w1"], cfg.init_psf_params()["w2"]
    sigma2 = sigma_init = float(problem.sigma2_init)
    gam, lam = float(problem.gamma), float(problem.lambda_myula)
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / theta
    boxes = dict(theta=cfg.theta.box, w1=specs["w1"].box, w2=specs["w2"].box,
                 sigma=tuple(float(b) for b in problem.sigma2_box))
    fix = dict(w1=specs["w1"].fix, w2=specs["w2"].fix, sigma=cfg.fix_sigma)
    true_vals = dict(w1=specs["w1"].true_value, w2=specs["w2"].true_value)
    X = y.copy()
    prox = oracles.np_chambolle(y, lam * theta, sapg.chambolle_iters)[0]
    with jax.default_device(jax.devices("cpu")[0]):
        key = jax.random.split(jax.random.key(3), 1)[0]
        for i in range(n_steps):
            key, sub = jax.random.split(key)
            Z = np.asarray(jax.random.normal(sub, y.shape, F32), np.float64)
            X, prox, theta, w1, w2, sigma2, _ = oracles.np_sapg_gaussian_step(
                X, prox, Z, y, theta, w1, w2, sigma2,
                cfg.psf_size, cfg.phi, gam, lam, d_scale, sapg.d_exp, i + 2,
                cfg.theta.step_scale, specs["w1"].step_scale,
                specs["w2"].step_scale, cfg.sigma_step_scale,
                boxes, fix, true_vals, sigma_init, sapg.chambolle_iters,
            )
    return dict(X=X, prox=prox, theta=theta, sigma2=sigma2, w1=w1, w2=w2)


def check_sapg(size: int, n_steps: int, device, cpu) -> dict:
    """SAPG steps on `device` against the same steps on `cpu` (same keys,
    f32) and against the f64 oracle started from `device`'s problem."""
    problem, got = sapg_steps(size, n_steps, device)
    _, on_cpu = sapg_steps(size, n_steps, cpu)
    want = oracle_sapg_steps(problem, n_steps)
    errs = {}
    for k in want:
        errs[f"{k}_vs_oracle"] = rel_err(got[k], want[k])
        errs[f"{k}_vs_cpu"] = rel_err(got[k], on_cpu[k])
    for k, v in errs.items():
        require(v < TOL["sapg"], f"sapg {k} error {v:.3g} >= {TOL['sapg']}")
    return errs


# ---------------------------------------------------------------------------
# Phase 4/5: size rung and timings
# ---------------------------------------------------------------------------

def wheel_problem(size: int, cfg=None):
    """The synthetic wheel at `size`² (Gaussian, w1/w2 estimated by default)."""
    cfg = _gaussian_free_w() if cfg is None else cfg
    return build_problem(synthetic_wheel(size), cfg, jax.random.key(0), dtype=F32)


def compile_steps(problem, n_chains: int, n_steps: int):
    """Compile a scan of `n_steps` SAPG steps; returns (compiled, carry)."""
    step, aux = make_sapg_step(problem, n_chains=n_chains)
    carry = initial_carry(problem, aux, n_chains, jax.random.key(1))
    iis = jnp.arange(2, n_steps + 2, dtype=F32)
    run = jax.jit(lambda c: jax.lax.scan(step, c, iis)[0])
    return run.lower(carry).compile(), carry


def chain_iters_per_sec(compiled, carry, n_chains: int, n_steps: int) -> float:
    """Post-compile chain-iterations/s: host clock around block_until_ready."""
    carry = jax.block_until_ready(compiled(carry))  # warm
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(carry))
    return n_steps * n_chains / (time.perf_counter() - t0)


def salsa_wall(size: int, iters: int) -> tuple:
    """Post-compile wall seconds of a fixed-length SALSA solve."""
    blur = BlurOperator((size, size), 7, F32)
    H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=F32))
    x = jnp.asarray(synthetic_wheel(size), F32)
    y = jax.jit(lambda v: blur.apply(v, jnp.asarray(H)))(x)
    y = y + 2.0 * jax.random.normal(jax.random.key(3), y.shape, F32)

    def solve():
        return salsa_tv(y, H, 0.12, 0.003, blur, max_iter=iters, tol=0.0, tv_iters=10)

    res = solve()  # compile
    t0 = time.perf_counter()
    solve()
    return time.perf_counter() - t0, res


def prox_time(size: int, n_chains: int) -> tuple:
    """Seconds per call of the vmapped XLA prox (SAPG's 25 sweeps) over 20
    calls, and the sweeps it ran."""
    calls = 20
    g = jnp.broadcast_to(jnp.asarray(_test_image(size), F32), (n_chains, size, size))
    prox = jax.jit(jax.vmap(lambda x: chambolle_prox(x, 0.05, 25)))
    f, st = jax.block_until_ready(prox(g))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(calls):
        f, st = prox(g)
    jax.block_until_ready(f)
    return (time.perf_counter() - t0) / calls, int(np.max(np.asarray(st.iters)))


H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def prox_roofline_share(seconds: float, size: int, n_chains: int, sweeps: int) -> float:
    """Least time over measured time, counting 5 f32 fields moved per sweep
    (read g/λ, px, py; write px, py) at the published HBM bandwidth."""
    bytes_moved = 5 * 4 * size * size * n_chains * sweeps
    return bytes_moved / H100_HBM_BYTES_PER_S / seconds


# ---------------------------------------------------------------------------
# --bands: full-budget operating-point gates
# ---------------------------------------------------------------------------

def band_gate(psf: str) -> dict:
    """Full reference budget (20k samples, 15k warm-up) at 512² on
    wheel.png, BSNR 30, one chain, with the bands of the photograph parity
    tables (RESULTS.md)."""
    cfg = dataclasses.replace(preset(psf), image="wheel")
    res, *_ = run_demo.run_demo(cfg, load_image("wheel"), n_chains=1, dtype=F32)
    sig = abs(np.log(res["sigma2_EB"] / res["sigma2_true"]))
    require(res["mse_db"] < res["mse_db_observation"] - 4.0, f"{psf}: gain < 4 dB")
    if psf == "laplace":
        require(abs(res["psf_params_EB"]["b"] - 0.3) < 0.08, f"laplace b {res}")
        require(sig < 0.06, f"laplace sigma2 {res}")
    elif psf == "gaussian":
        require(sig < 0.08, f"gaussian sigma2 {res}")
        require(0.01 < res["theta_EB"] < 0.04, f"gaussian theta {res}")
    else:
        # β is the weakly identified axis and is not gated
        require(abs(res["psf_params_EB"]["alpha"] - 0.4) < 0.06, f"moffat alpha {res}")
        require(sig < 0.08, f"moffat sigma2 {res}")
    return res


def size_smoke(size: int) -> dict:
    """Small-budget end-to-end run at `size`² (Gaussian, w1/w2 estimated):
    the MAP image must beat the observation by more than 5 dB."""
    samples, warmup, outer = {2048: (60, 30, 80), 4096: (40, 20, 60)}[size]
    cfg = _gaussian_free_w()
    cfg = dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(cfg.sapg, samples=samples, warmup=warmup,
                                 burn_in=(samples * 80) // 100),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=outer),
    )
    res, *_ = run_demo.run_demo(cfg, synthetic_wheel(size), n_chains=1, dtype=F32)
    gain = res["mse_db_observation"] - res["mse_db"]
    require(np.isfinite(res["mse_db"]) and gain > 5.0, f"{size}² smoke: {res}")
    return res


# ---------------------------------------------------------------------------
# --four: the multi-device paths
# ---------------------------------------------------------------------------

def _short_gaussian(samples: int, warmup: int, **sapg_over):
    cfg = _gaussian_free_w()
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup,
        burn_in=(samples * 80) // 100, **sapg_over))


def _trace_errs(got, ref) -> dict:
    errs = {"theta": rel_err(got.thetas, ref.thetas),
            "sigma2": rel_err(got.sigma2s, ref.sigma2s),
            "X_last": rel_err(got.X_last, ref.X_last)}
    for n in ref.psf_param_traces:
        errs[n] = rel_err(got.psf_param_traces[n], ref.psf_param_traces[n])
    for k, v in errs.items():
        require(v < TOL["mesh"], f"sharded {k} trace error {v:.3g} >= {TOL['mesh']}")
    return errs


def check_chain_mesh(devices, size: int, n_chains: int, samples: int, warmup: int) -> dict:
    """run_sapg on a ('data', 'chains') = (1, len(devices)) mesh against the
    same chains with the same keys on devices[0]."""
    cfg = _short_gaussian(samples, warmup)
    with jax.default_device(devices[0]):
        problem = build_problem(synthetic_wheel(size), cfg, jax.random.key(5), dtype=F32)
        ref = run_sapg(problem, jax.random.key(6), n_chains=n_chains)
        mesh = make_mesh(data=1, chains=len(devices), devices=devices)
        got = run_sapg(problem, jax.random.key(6), n_chains=n_chains, mesh=mesh)
    return _trace_errs(got, ref)


def check_space_mesh(devices, size: int, samples: int, warmup: int) -> dict:
    """run_sapg_spatial with the image row-sharded over len(devices)
    devices against the single-device run in the same ('dft') mode."""
    cfg = _short_gaussian(samples, warmup, fft_mode="dft")
    with jax.default_device(devices[0]):
        problem = build_problem(synthetic_wheel(size), cfg, jax.random.key(5), dtype=F32)
        ref = run_sapg(problem, jax.random.key(6), n_chains=1)
        got = run_sapg_spatial(
            problem, make_spatial_mesh(len(devices), devices), jax.random.key(6))
    return _trace_errs(got, ref)


# ---------------------------------------------------------------------------

def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def run_one_card(bands: bool) -> None:
    # phase 1: the main path, the reference's published experiment
    t0 = time.perf_counter()
    r = demo("gaussian", 512, samples=400, warmup=200, chains=1)
    report(1, "main-path", f"gaussian wheel 512² 1 chain: theta_EB={r['theta_EB']:.5g} "
           f"sigma2_EB={r['sigma2_EB']:.5g} mse_db={r['mse_db']:.4f} < "
           f"observation {r['mse_db_observation']:.4f}; wall "
           f"{time.perf_counter() - t0:.1f} s incl. compile; ok")

    # phase 2: the other PSF families, vmapped multi-chain step
    for psf in ("laplace", "moffat"):
        r = demo(psf, 512, samples=400, warmup=200, chains=4)
        report(2, "families", f"{psf} wheel 512² 4 chains: psf_EB={r['psf_params_EB']} "
               f"mse_db={r['mse_db']:.4f} < {r['mse_db_observation']:.4f}; ok")

    # phase 3: correctness on the card
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    report(3, "prox-512", _fmt(check_prox(512, gpu))
           + f" (tol f {TOL['prox']}, duals {TOL['prox_duals']}); ok")
    report(3, "salsa-256", _fmt(check_salsa(256, gpu)) + f" (tol {TOL['salsa']}); ok")
    report(3, "sapg-512x5", _fmt(check_sapg(512, 5, gpu, cpu)) + f" (tol {TOL['sapg']}); ok")

    # phase 4: size rung
    compiled_2k, carry_2k = compile_steps(wheel_problem(2048), n_chains=2, n_steps=20)
    out = jax.block_until_ready(compiled_2k(carry_2k))
    require(bool(np.all(np.isfinite(np.asarray(out[0])))), "2048² SAPG sample not finite")
    mem = compiled_2k.memory_analysis()
    report(4, "size-2048", "SAPG 2 chains x 20 steps finite; memory_analysis: "
           f"arguments {mem.argument_size_in_bytes / 2**20:.1f} MiB, outputs "
           f"{mem.output_size_in_bytes / 2**20:.1f} MiB, temp "
           f"{mem.temp_size_in_bytes / 2**20:.1f} MiB, code "
           f"{mem.generated_code_size_in_bytes / 2**20:.2f} MiB; ok")
    secs_2k, res = salsa_wall(2048, 30)
    require(bool(np.all(np.isfinite(res.x))), "2048² SALSA not finite")
    require(res.objective[-1] < res.objective[0], "2048² SALSA objective did not fall")
    report(4, "salsa-2048", f"30 outer iterations finite, objective "
           f"{res.objective[0]:.6g} -> {res.objective[-1]:.6g}; ok")

    # phase 5: informational timings (smoke readings, not benchmark cells)
    rates = {}
    for size, chains, steps in ((512, 1, 200), (512, 16, 100)):
        c, carry = compile_steps(wheel_problem(size), chains, steps)
        rates[f"{size}_c{chains}"] = chain_iters_per_sec(c, carry, chains, steps)
    rates["2048_c2"] = chain_iters_per_sec(compiled_2k, carry_2k, 2, 20)
    report(5, "sapg-rate", "post-compile chain-iter/s " + " ".join(
        f"{k}={v:.1f}" for k, v in rates.items()))
    secs_512, _ = salsa_wall(512, 330)
    report(5, "salsa-512", f"330 outer iterations {secs_512:.4f} s post-compile "
           f"(2048² x 30: {secs_2k:.4f} s)")
    sec, sweeps = prox_time(512, 16)
    share = prox_roofline_share(sec, 512, 16, sweeps)
    report(5, "prox-512x16", f"XLA chambolle_prox {sec * 1e3:.4f} ms/call, "
           f"{sweeps} sweeps, {share:.3f} of the 3.35 TB/s HBM roofline "
           f"(5 f32 fields per sweep)")

    if bands:
        for psf in ("gaussian", "laplace", "moffat"):
            t0 = time.perf_counter()
            r = band_gate(psf)
            report("bands", psf, f"512² full budget: theta_EB={r['theta_EB']:.5g} "
                   f"sigma2_EB={r['sigma2_EB']:.5g} (true {r['sigma2_true']:.5g}) "
                   f"psf_EB={r['psf_params_EB']} mse_db={r['mse_db']:.4f} vs "
                   f"{r['mse_db_observation']:.4f}; wall {time.perf_counter() - t0:.1f} s; ok")
        for size in (2048, 4096):
            r = size_smoke(size)
            report("bands", f"smoke-{size}", f"gain "
                   f"{r['mse_db_observation'] - r['mse_db']:.3f} dB; ok")


def run_four() -> None:
    devices = jax.devices()
    require(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    devices = devices[:4]
    e = check_chain_mesh(devices, 512, n_chains=8, samples=100, warmup=50)
    report("four", "chains-mesh-1x4", "8 chains 512² vs one card: " + _fmt(e)
           + f" (tol {TOL['mesh']}); ok")
    e = check_space_mesh(devices, 2048, samples=30, warmup=10)
    report("four", "space-mesh-4", "2048² rows over 4 cards vs one card (dft): "
           + _fmt(e) + f" (tol {TOL['mesh']}); ok")


def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_mutually_exclusive_group()
    g.add_argument("--bands", action="store_true",
                   help="also run the full-budget operating-point gates")
    g.add_argument("--four", action="store_true",
                   help="run only the four-card mesh phases")
    args = p.parse_args(argv)

    # phase 0: device check, before any work
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_persistent_cache()
    CARD = card_name_and_power()
    report(0, "device", f"{dev.platform} {dev.device_kind} x{len(jax.devices())}; ok")

    if args.four:
        run_four()
    else:
        run_one_card(args.bands)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

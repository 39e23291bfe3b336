"""Benchmark: SAPG iteration throughput + SALSA MAP latency on one GPU.

Prints ONE JSON line whose primary metric is chain-batched SAPG throughput
at 16 chains, 512²:

  {"metric": "sapg_chain_iters_per_sec_512_c16", "value": N,
   "unit": "chain-iter/s", "device": {...}, "vs_baseline": R, ...}

"device" names the platform, device kind, device count and the card's
power limit.  The script refuses to run without an NVIDIA GPU.

The reference publishes no numbers (BASELINE.md), so the baseline is the
per-iteration cost of the reference algorithm measured here, on this host,
with a NumPy implementation of the reference's per-iteration math
(full-spectrum FFT A/Aᵀ + hyper-gradient FFTs + 25-iter Chambolle prox).
vs_baseline = value / cpu_ref_iters_per_sec.

Env knobs: BENCH_SIZE (512), BENCH_STEPS (200), BENCH_CHAINS (16),
BENCH_FFT_MODE, BENCH_FAST=1 skips the single-chain, SALSA and size-ladder
extras, BENCH_LADDER=0 skips only the ladder.  The persistent XLA compile
cache (runtime/cache.py) makes repeat runs start in seconds.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from semiblind_tv.runtime.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import numpy as np

SIZE = int(os.environ.get("BENCH_SIZE", "512"))
FLAGSHIP_CHAINS = int(os.environ.get("BENCH_CHAINS", "16"))
N_STEPS = int(os.environ.get("BENCH_STEPS", "200"))
FAST = os.environ.get("BENCH_FAST", "0") == "1"


def _problem(size=None):
    import dataclasses

    from chip_smoke import wheel_problem
    from semiblind_tv.runtime import gaussian_preset

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    fft_mode = os.environ.get("BENCH_FFT_MODE")
    if fft_mode:
        cfg = dataclasses.replace(
            cfg, sapg=dataclasses.replace(cfg.sapg, fft_mode=fft_mode)
        )
    return wheel_problem(SIZE if size is None else size, cfg)


def bench_sapg(problem, n_chains, n_steps=None):
    """Post-compile steady-state chain-iterations/sec of the SAPG hot loop."""
    from chip_smoke import chain_iters_per_sec, compile_steps

    n_steps = N_STEPS if n_steps is None else n_steps
    compiled, carry = compile_steps(problem, n_chains, n_steps)
    return chain_iters_per_sec(compiled, carry, n_chains, n_steps)


def bench_salsa(problem):
    """512² MAP solve: 330 fixed outer iterations, post-compile wall
    seconds."""
    from semiblind_tv.solvers import salsa_tv

    def solve():
        return salsa_tv(
            problem.y, problem.H_true,
            tau=0.1 * problem.sigma2_init, mu=0.01, blur=problem.blur,
            max_iter=330, tol=0.0, tv_iters=10, x_true=problem.x_true,
        )

    solve()  # compile
    t0 = time.perf_counter()
    solve()
    return time.perf_counter() - t0


def bench_cpu_reference():
    """Reference per-iteration math in NumPy (MATLAB-equivalent work)."""
    rng = np.random.default_rng(0)
    x = rng.random((SIZE, SIZE)) * 255.0
    y = x + rng.standard_normal((SIZE, SIZE))

    s = 7
    offs = np.arange(s) - (s - 1) / 2.0
    v, u = offs[:, None], offs[None, :]

    def kern(w1, w2):
        f = (w1 * w2) / (2 * np.pi) * np.exp(-(w1**2 * u**2 + w2**2 * v**2) / 2)
        return f / f.sum()

    def otf(k):
        p = np.zeros((SIZE, SIZE))
        p[:s, :s] = k
        return np.fft.fft2(p)

    def chambolle(g, lam, iters):
        px = np.zeros_like(g)
        py = np.zeros_like(g)
        for _ in range(iters):
            un = (
                np.concatenate([px[:1], px[1:-1] - px[:-2], -px[-1:]], 0)
                + np.concatenate([py[:, :1], py[:, 1:-1] - py[:, :-2], -py[:, -1:]], 1)
                - g / lam
            )
            ux = np.concatenate([un[1:] - un[:-1], np.zeros((1, SIZE))], 0)
            uy = np.concatenate([un[:, 1:] - un[:, :-1], np.zeros((SIZE, 1))], 1)
            t = np.sqrt(ux**2 + uy**2)
            px = (px + 0.249 * ux) / (1 + 0.249 * t)
            py = (py + 0.249 * uy) / (1 + 0.249 * t)
        div = np.concatenate([px[:1], px[1:-1] - px[:-2], -px[-1:]], 0) + np.concatenate(
            [py[:, :1], py[:, 1:-1] - py[:, :-2], -py[:, -1:]], 1
        )
        return g - lam * div

    X = y.copy()
    n_iter = max(3, 2000 // (SIZE // 8))  # keep the CPU measurement short
    t0 = time.perf_counter()
    for i in range(n_iter):
        # per-iteration work of SAPG_algorithm_Guassian.m:158-194
        H = otf(kern(0.5, 0.3))
        dH1 = otf(kern(0.51, 0.3))  # gradient-kernel OTF (same cost)
        dH2 = otf(kern(0.5, 0.31))
        AX = np.real(np.fft.ifft2(H * np.fft.fft2(X)))
        gradF = np.real(np.fft.ifft2(np.conj(H) * np.fft.fft2(AX - y)))
        X = np.abs(X - 1e-5 * gradF + 1e-3 * rng.standard_normal((SIZE, SIZE)))
        X = chambolle(X, 0.01, 25)
        r = np.real(np.fft.ifft2(H * np.fft.fft2(X))) - y
        np.sum(np.real(np.fft.ifft2(dH1 * np.fft.fft2(X))) * r)
        np.sum(np.real(np.fft.ifft2(dH2 * np.fft.fft2(X))) * r)
        np.sum(np.sqrt((X - np.roll(X, 1, 0)) ** 2 + (X - np.roll(X, 1, 1)) ** 2))
    dt = time.perf_counter() - t0
    return n_iter / dt


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    from chip_smoke import card_name_and_power

    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), power_limit=card_name_and_power())
    problem = _problem()
    flagship_rate = bench_sapg(problem, FLAGSHIP_CHAINS)
    extras = {}
    if not FAST:
        extras["single_chain_iters_per_sec"] = round(bench_sapg(problem, 1), 3)
        extras["salsa_map_512_330iter_s"] = round(bench_salsa(problem), 3)
        if SIZE == 512 and os.environ.get("BENCH_LADDER", "1") == "1":
            # size-ladder rungs: 1024² at 4 chains, 2048² at 2 chains, and
            # a 100-iteration 2048² MAP solve
            extras["ladder_1024_c4_iters_per_sec"] = round(
                bench_sapg(_problem(1024), 4, n_steps=40), 3)
            prob_m = _problem(2048)
            extras["ladder_2048_c2_iters_per_sec"] = round(
                bench_sapg(prob_m, 2, n_steps=30), 3)
            from semiblind_tv.solvers import salsa_tv

            def _solve_2048():
                return salsa_tv(
                    prob_m.y, prob_m.H_true,
                    tau=0.1 * prob_m.sigma2_init, mu=0.01,
                    blur=prob_m.blur, max_iter=100, tol=0.0, tv_iters=10,
                )

            _solve_2048()  # compile
            t0 = time.perf_counter()
            _solve_2048()
            extras["salsa_map_2048_100iter_s"] = round(time.perf_counter() - t0, 3)
    # median of 3 to stabilise the host-load-sensitive CPU baseline
    cpu_rate = sorted(bench_cpu_reference() for _ in range(3))[1]
    print(
        json.dumps(
            {
                "metric": f"sapg_chain_iters_per_sec_{SIZE}_c{FLAGSHIP_CHAINS}",
                "value": round(flagship_rate, 3),
                "unit": "chain-iter/s",
                "device": device,
                "vs_baseline": round(flagship_rate / cpu_rate, 3),
                "cpu_ref_iters_per_sec": round(cpu_rate, 3),
                **extras,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

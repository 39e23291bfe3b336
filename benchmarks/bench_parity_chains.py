"""Wall-clock-to-parity vs chains (BASELINE.md north star).

The chains axis exists to cut the wall-clock needed to reach the
reference's quality; this measures that trade directly.  For each
(n_chains, budget-fraction) cell it runs the COMPLETE Gaussian wheel.png
512^2 pipeline (observation synthesis -> warm-up -> SAPG -> SALSA MAP,
published configuration: w pinned, run_Gaussian_demo.m:42-43) with the
sample/warm-up budget scaled by the fraction, then scores the outcome
against the r3 full-budget operating-point band
(tests/test_gpu.py::test_operating_point_bands_gaussian_wheel):

    in_band =  |log(sigma2_EB / sigma2_true)| < 0.08
           AND 0.01 < theta_EB < 0.04
           AND mse_db < mse_db_observation - 4 dB

Each row prints as one JSON line (stream-safe for the long run); the final
summary names the fastest in-band cell.  Budget fractions scale BOTH
samples and warmup (the reference's 20k/15k split).

Usage (one GPU; ~12 cells x (compile + run)):
    python benchmarks/bench_parity_chains.py
    BENCH_CELLS="1:1.0,8:0.25" python benchmarks/bench_parity_chains.py
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from semiblind_tv.runtime.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import jax.numpy as jnp
import numpy as np


def parse_cells():
    spec = os.environ.get(
        "BENCH_CELLS",
        ",".join(f"{c}:{f}" for c in (1, 8, 16, 24) for f in (1.0, 0.5, 0.25)),
    )
    out = []
    for cell in spec.split(","):
        c, f = cell.split(":")
        out.append((int(c), float(f)))
    return out


def run_cell(n_chains, frac, image):
    from semiblind_tv.cli.run_demo import run_demo
    from semiblind_tv.runtime import gaussian_preset

    cfg = gaussian_preset()
    samples = max(100, int(round(20_000 * frac)))
    warmup = max(75, int(round(15_000 * frac)))
    cfg = dataclasses.replace(
        cfg,
        image="wheel",
        sapg=dataclasses.replace(
            cfg.sapg, samples=samples, warmup=warmup,
            burn_in=(samples * 80) // 100,
        ),
    )
    t0 = time.time()
    results, *_ = run_demo(cfg, image, n_chains=n_chains, dtype=jnp.float32)
    wall = time.time() - t0
    in_band = (
        abs(np.log(results["sigma2_EB"] / results["sigma2_true"])) < 0.08
        and 0.01 < results["theta_EB"] < 0.04
        and results["mse_db"] < results["mse_db_observation"] - 4.0
    )
    return {
        "n_chains": n_chains, "budget_frac": frac,
        "samples": samples, "warmup": warmup,
        "sapg_wall_s": round(results["sapg_time_s"], 2),
        "total_wall_s": round(wall, 2),
        "theta_EB": round(results["theta_EB"], 5),
        "sigma2_EB": round(results["sigma2_EB"], 4),
        "sigma2_true": round(results["sigma2_true"], 4),
        "mse_db": round(results["mse_db"], 3),
        "mse_db_obs": round(results["mse_db_observation"], 3),
        "ssim": round(results["ssim"], 4),
        "in_band": bool(in_band),
    }


def main():
    from chip_smoke import card_name_and_power
    from semiblind_tv.utils import load_image

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_parity_chains: needs an NVIDIA GPU, JAX found {dev.platform}")
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), power_limit=card_name_and_power())

    image = load_image("wheel")
    rows = []
    for n_chains, frac in parse_cells():
        row = {"device": device, **run_cell(n_chains, frac, image)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    in_band = [r for r in rows if r["in_band"]]
    summary = {"summary": True, "device": device, "cells": len(rows),
               "in_band": len(in_band)}
    if in_band:
        best = min(in_band, key=lambda r: r["sapg_wall_s"])
        summary["fastest_in_band"] = {
            k: best[k] for k in ("n_chains", "budget_frac", "sapg_wall_s",
                                 "mse_db", "theta_EB")
        }
        # steady-state walls (all programs now jit-cached in-process): the
        # single-chain full-budget reference point vs the fastest in-band
        # cell — first-run walls above include each cell's compile
        ref_steady = run_cell(1, 1.0, image)
        best_steady = run_cell(best["n_chains"], best["budget_frac"], image)
        summary["steady_reference_1x1.0"] = {
            k: ref_steady[k] for k in ("sapg_wall_s", "mse_db", "in_band")
        }
        summary["steady_fastest_in_band"] = {
            k: best_steady[k]
            for k in ("n_chains", "budget_frac", "sapg_wall_s", "mse_db",
                      "in_band")
        }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

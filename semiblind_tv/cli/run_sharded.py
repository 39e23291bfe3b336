"""Sharded SAPG driver: D data-parallel problems × C chains on a device mesh.

The multi-chip production entry point (single-host it uses the local
devices; multi-host after runtime.distributed.initialize()).  Each problem
is an independent image (the reference driver's `for i_im` loop,
run_Gaussian_demo.m:100); chains of the same problem pmean their SA
statistics each step.  Runs the COMPLETE reference pipeline on the mesh:
warm-up, main SAPG scan, per-problem EB extraction and (unless --no-map)
the SALSA MAP solve with the plugged-in estimates
(SAPG_algorithm_Guassian.m:67-306 + run_Gaussian_demo.m:219-242).

  python -m semiblind_tv.cli.run_sharded --psf gaussian --size 64 \
      --data 2 --chains-per-shard 2 --samples 200 --warmup 100

`--bare --steps N` runs the bare stepper instead (throughput measurement,
no warm-up/EB/MAP).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.parallel.mesh import CHAINS_AXIS, DATA_AXIS, make_mesh
from semiblind_tv.parallel.sapg_parallel import (
    run_sapg_sharded,
    run_sapg_sharded_steps,
)
from semiblind_tv.runtime import build_problem, preset
from semiblind_tv.utils import load_image


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--data", type=int, default=None,
                   help="data-axis size (independent problems); default 1")
    p.add_argument("--chains-per-shard", type=int, default=1)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--no-fix-w", action="store_true")
    p.add_argument("--no-map", action="store_true",
                   help="skip the per-problem SALSA MAP solve")
    p.add_argument("--checkpoint", default=None,
                   help="mid-run checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--bare", action="store_true",
                   help="bare stepper (no warm-up/EB/MAP) for throughput")
    p.add_argument("--steps", type=int, default=1000,
                   help="bare-stepper iteration count")
    args = p.parse_args(argv)

    n_dev = len(jax.devices())
    data = args.data if args.data is not None else 1
    if n_dev % data != 0:
        raise SystemExit(f"{n_dev} devices not divisible by data={data}")
    mesh = make_mesh(data=data, chains=n_dev // data)

    kwargs = {}
    if args.psf == "gaussian" and args.no_fix_w:
        kwargs.update(fix_w1=False, fix_w2=False)
    cfg = preset(args.psf, **kwargs)
    sapg_over = {}
    if args.samples is not None:
        sapg_over.update(samples=args.samples, burn_in=(args.samples * 80) // 100)
    if args.warmup is not None:
        sapg_over["warmup"] = args.warmup
    if sapg_over:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg_over))
    image = load_image(args.image, size=args.size)
    keys = jax.random.split(jax.random.key(args.seed), data)
    problems = [build_problem(image, cfg, keys[i]) for i in range(data)]
    run_key = jax.random.key(args.seed + 1)

    if args.bare:
        t0 = time.perf_counter()
        state, thetas = run_sapg_sharded_steps(
            problems, mesh, run_key,
            chains_per_shard=args.chains_per_shard, n_steps=args.steps,
        )
        dt = time.perf_counter() - t0
        total_chain_iters = data * state["X"].shape[1] * args.steps
        out = {
            "mesh": {DATA_AXIS: data, CHAINS_AXIS: n_dev // data},
            "devices": n_dev,
            "chains_per_problem": int(state["X"].shape[1]),
            "steps": args.steps,
            "wall_s": round(dt, 3),
            "chain_iters_per_sec": round(total_chain_iters / dt, 1),
            "theta_last": [float(t) for t in thetas[:, -1]],
            "sigma2_last": [float(s) for s in np.asarray(state["sigma2"])],
        }
        print(json.dumps(out, indent=2))
        return out

    t0 = time.perf_counter()
    results = run_sapg_sharded(
        problems, mesh, run_key,
        chains_per_shard=args.chains_per_shard,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
    )
    sapg_dt = time.perf_counter() - t0

    C = results[0].X_last.shape[0]
    total_iters = data * C * (cfg.sapg.samples - 1 + max(cfg.sapg.warmup - 1, 0))
    out = {
        "mesh": {DATA_AXIS: data, CHAINS_AXIS: n_dev // data},
        "devices": n_dev,
        "chains_per_problem": C,
        "samples": cfg.sapg.samples,
        "warmup": cfg.sapg.warmup,
        "sapg_wall_s": round(sapg_dt, 3),
        "chain_iters_per_sec": round(total_iters / sapg_dt, 1),
        "problems": [],
    }
    for d, (prob, res) in enumerate(zip(problems, results)):
        entry = {
            "theta_EB": res.theta_EB,
            "sigma2_EB": res.sigma2_EB,
            "sigma2_true": float(prob.sigma_true) ** 2,
            "psf_params_EB": res.psf_params_EB,
        }
        if not args.no_map:
            from semiblind_tv import metrics
            from semiblind_tv.solvers import salsa_tv

            params_EB = {k: jnp.asarray(v, prob.blur.dtype)
                         for k, v in res.psf_params_EB.items()}
            H_EB = prob.blur.otf_host(prob.model.kernel(params_EB))
            salsa = salsa_tv(
                prob.y, H_EB,
                tau=res.theta_EB * res.sigma2_EB,
                mu=res.theta_EB * cfg.salsa.mu_factor,
                blur=prob.blur,
                max_iter=cfg.salsa.outer_iters,
                tol=cfg.salsa.tol,
                tv_iters=cfg.salsa.tv_iters,
                x_true=prob.x_true,
            )
            entry.update(
                mse_db=float(metrics.mse_db(prob.x_true, jnp.asarray(salsa.x))),
                ssim=float(metrics.ssim(prob.x_true, jnp.asarray(salsa.x))),
                salsa_iters=salsa.n_iters,
            )
        out["problems"].append(entry)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

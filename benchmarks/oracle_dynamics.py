"""Independent NumPy certification of the reference's SAPG dynamics.

Runs tests/oracles.py::np_sapg_dynamics_run — a from-scratch NumPy
re-implementation of the reference estimators (Laplace anchor
SAPG_algorithm_laplace.m:130-215, Moffat anchor SAPG_algorithm_moffat.m:
135-205, demo setup run_*_demo.m) with its own RNG stream — on a chosen
image at the full 512² operating point, and prints the EB endpoints.

Agreement of the drift endpoints (e.g. Moffat β_EB far above truth on
wheel.png) between this simulator and the JAX package certifies the drift
is the *method's* behavior on that image, not an implementation artifact
(same certification style as the Laplace b-drift note in RESULTS.md).

    python benchmarks/oracle_dynamics.py --psf moffat --image wheel \
        [--samples 20000 --warmup 15000] [--size 512]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="moffat")
    p.add_argument("--image", default="wheel")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--samples", type=int, default=20_000)
    p.add_argument("--warmup", type=int, default=15_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--psf-log-scale", action="store_true",
                   help="probe: log-space PSF-parameter updates (matches "
                        "run_demo --psf-log-scale)")
    args = p.parse_args(argv)

    import oracles
    from semiblind_tv.utils import load_image, synthetic_wheel

    if args.image == "phantom":
        x = np.asarray(synthetic_wheel(args.size), dtype=np.float64)
    else:
        x = np.asarray(load_image(args.image, size=args.size), dtype=np.float64)

    t0 = time.time()
    res = oracles.np_sapg_dynamics_run(
        x, args.psf, seed=args.seed, samples=args.samples, warmup=args.warmup,
        progress=500, fast=True, psf_log_scale=args.psf_log_scale,
    )
    wall = time.time() - t0
    summary = {
        k: v for k, v in res.items() if isinstance(v, float)
    }
    summary.update(psf=args.psf, image=args.image, size=args.size,
                   samples=args.samples, warmup=args.warmup, wall_s=wall)
    print(json.dumps(summary, indent=2), flush=True)
    if args.out:
        np.savez(args.out + ".npz", **{k: v for k, v in res.items()
                                       if isinstance(v, np.ndarray)})
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()

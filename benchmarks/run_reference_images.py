"""End-to-end parity sweep over the reference's own test photographs.

Runs the demo pipeline (observation synthesis → SAPG → SALSA MAP → metrics)
on every grayscale PNG the reference ships (images/: barbara, boat, bridge,
goldhill, lake, man, mandrill, wheel — run_Gaussian_demo.m:93-100), writing
one results.json per image and a runStats-style aggregate (the reference's
SALSA/runStats.m averages MSE/time over a results directory).

    SEMIBLIND_TV_IMAGES=/path/to/reference/images \
        python benchmarks/run_reference_images.py --psf gaussian \
        --out /tmp/parity_gaussian [--images wheel,boat] [--samples N]

One process for all images: identical shapes reuse the compiled programs.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--out", default="/tmp/parity_images")
    p.add_argument("--images", default=None, help="comma list; default: all available")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--no-fix-w", action="store_true")
    args = p.parse_args(argv)

    from semiblind_tv.cli.run_demo import main as demo_main
    from semiblind_tv.runtime.checkpoint import run_stats
    from semiblind_tv.utils import available_images

    names = (args.images.split(",") if args.images else available_images())
    if not names:
        raise SystemExit("no images found — set SEMIBLIND_TV_IMAGES")

    os.makedirs(args.out, exist_ok=True)
    for name in names:
        out = os.path.join(args.out, name)
        argv2 = ["--psf", args.psf, "--image", name, "--size", str(args.size),
                 "--chains", str(args.chains), "--out", out]
        if args.samples is not None:
            argv2 += ["--samples", str(args.samples)]
        if args.warmup is not None:
            argv2 += ["--warmup", str(args.warmup)]
        if args.no_fix_w:
            argv2 += ["--no-fix-w"]
        print(f"=== {name} ===", flush=True)
        demo_main(argv2)

    agg = run_stats(args.out)
    with open(os.path.join(args.out, "aggregate.json"), "w") as f:
        json.dump(agg, f, indent=2)
    print(json.dumps({"aggregate": agg}), flush=True)


if __name__ == "__main__":
    main()

"""Wavelet-synthesis L1 deblurring experiment driver.

The reference's SIAM 4.2.3 experiment (`SALSA/run_deblur_synthesis_L1.m`):
uniform 9-px blur, redundant 4-level Haar synthesis representation, L1
prior with SAPG Algorithm-1 θ estimation, SALSA MAP solve with
Sherman-Morrison LS step.

Usage:
  python -m semiblind_tv.cli.run_wavelet_l1 --image wheel --size 256 \
      --samples 3000 --levels 4
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp

from semiblind_tv.sapg.wavelet_l1 import WaveletL1Config, run_sapg_wavelet_l1
from semiblind_tv.utils import load_image


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default="wheel")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--samples", type=int, default=3000)
    p.add_argument("--burn-in", type=int, default=20)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--filter-order", type=int, default=2,
                   help="daubcqf(N) Daubechies filter length (2 = Haar, the "
                        "reference configuration)")
    p.add_argument("--blur-length", type=int, default=9)
    p.add_argument("--bsnr", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    cfg = WaveletL1Config(
        samples=args.samples,
        burn_in=args.burn_in,
        levels=args.levels,
        wavelet_order=args.filter_order,
        blur_length=args.blur_length,
        bsnr=args.bsnr,
    )
    image = load_image(args.image, args.image_dir, size=args.size)
    res = run_sapg_wavelet_l1(image, cfg, jax.random.key(args.seed), dtype=dtype)
    out = {
        "theta_EB": res.theta_EB,
        "mse_db": res.mse_db,
        "salsa_iters": res.salsa_iters,
        "samples": cfg.samples,
        "levels": cfg.levels,
        "wavelet_order": cfg.wavelet_order,
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

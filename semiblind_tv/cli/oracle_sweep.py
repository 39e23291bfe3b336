"""Oracle sweep validation of the EB estimates.

Capability of the reference's `SALSA/salsa_m.m:234-326` and
`salsa_m_sigma.m:196-234`: after (optionally) running SAPG, grid the
regularisation parameter (and σ²), run the SALSA MAP solve at every grid
point against the ground truth, locate the MSE-minimising *oracle* value,
and report it next to the EB estimate.  This is the reference's main
validation that empirical-Bayes estimation lands near the oracle.

Usage:
  python -m semiblind_tv.cli.oracle_sweep --psf gaussian --size 128 \
      --samples 2000 --warmup 1000 --grid 15
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv import metrics
from semiblind_tv.runtime import build_problem, preset
from semiblind_tv.sapg import run_sapg
from semiblind_tv.solvers import salsa_tv
from semiblind_tv.utils import load_image

__all__ = ["oracle_sweep", "main"]


def oracle_sweep(
    problem,
    thetas: Sequence[float],
    sigma2: float,
    salsa_cfg,
    psf_params=None,
):
    """MSE(dB) of the SALSA MAP solve for each theta in the grid.

    tau = theta * sigma2, mu = theta/10 — exactly how the demos plug the EB
    estimates into SALSA (run_Gaussian_demo.m:219-230).
    Returns (mses_db, oracle_theta, oracle_mse_db).
    """
    params = psf_params or {
        k: jnp.asarray(v) for k, v in problem.cfg.true_psf_params().items()
    }
    H = problem.blur.otf_host(problem.model.kernel(params))
    mses = []
    for th in thetas:
        res = salsa_tv(
            problem.y,
            H,
            tau=float(th) * sigma2,
            mu=float(th) * salsa_cfg.mu_factor,
            blur=problem.blur,
            max_iter=salsa_cfg.outer_iters,
            tol=salsa_cfg.tol,
            tv_iters=salsa_cfg.tv_iters,
            x_true=problem.x_true,
        )
        mses.append(
            float(metrics.mse_db(problem.x_true, jnp.asarray(res.x)))
        )
    mses = np.asarray(mses)
    i = int(np.argmin(mses))
    return mses, float(thetas[i]), float(mses[i])


def tau_sweep(problem, taus: Sequence[float], salsa_cfg, psf_params=None):
    """Direct τ-grid sweep — the reference's `Tau_op` loop
    (SALSA/salsa_m.m:234-280): SALSA is run at each raw τ (no θ·σ²
    coupling), µ = τ·mu_factor, and the MSE-minimising oracle τ reported.
    Returns (mses_db, oracle_tau, oracle_mse_db)."""
    params = psf_params or {
        k: jnp.asarray(v) for k, v in problem.cfg.true_psf_params().items()
    }
    H = problem.blur.otf_host(problem.model.kernel(params))
    mses = []
    for tau in taus:
        res = salsa_tv(
            problem.y,
            H,
            tau=float(tau),
            mu=float(tau) * salsa_cfg.mu_factor,
            blur=problem.blur,
            max_iter=salsa_cfg.outer_iters,
            tol=salsa_cfg.tol,
            tv_iters=salsa_cfg.tv_iters,
            x_true=problem.x_true,
        )
        mses.append(float(metrics.mse_db(problem.x_true, jnp.asarray(res.x))))
    mses = np.asarray(mses)
    i = int(np.argmin(mses))
    return mses, float(taus[i]), float(mses[i])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--grid", type=int, default=11)
    p.add_argument("--theta-min", type=float, default=None)
    p.add_argument("--theta-max", type=float, default=None)
    p.add_argument("--no-sapg", action="store_true",
                   help="sweep only (uses true sigma^2, skips EB estimation)")
    p.add_argument("--sigma-grid", type=int, default=0,
                   help="also sweep sigma^2 over N log-spaced points "
                        "(salsa_m_sigma.m capability)")
    p.add_argument("--tau-grid", type=int, default=0,
                   help="also sweep raw tau directly over N log-spaced "
                        "points, decoupled from theta (salsa_m.m Tau_op)")
    p.add_argument("--tau-min", type=float, default=None)
    p.add_argument("--tau-max", type=float, default=None)
    p.add_argument("--seed", type=int, default=1)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = preset(args.psf)
    cfg = dataclasses.replace(
        cfg,
        seed=args.seed,
        sapg=dataclasses.replace(
            cfg.sapg, samples=args.samples, warmup=args.warmup,
            burn_in=(args.samples * 80) // 100,
        ),
    )
    image = load_image(args.image, size=args.size)
    key = jax.random.key(args.seed)
    k_prob, k_sapg = jax.random.split(key)
    problem = build_problem(image, cfg, k_prob)

    out = {"psf": args.psf, "size": args.size}
    if args.no_sapg:
        theta_EB = None
        sigma2 = float(problem.sigma_true) ** 2
    else:
        sapg = run_sapg(problem, k_sapg)
        theta_EB = sapg.theta_EB
        sigma2 = sapg.sigma2_EB
        out.update(theta_EB=theta_EB, sigma2_EB=sigma2)

    lo = args.theta_min if args.theta_min is not None else cfg.theta.box[0]
    hi = args.theta_max if args.theta_max is not None else cfg.theta.box[1]
    grid = np.exp(np.linspace(np.log(lo), np.log(hi), args.grid))
    mses, oracle_theta, oracle_mse = oracle_sweep(problem, grid, sigma2, cfg.salsa)
    out.update(
        theta_grid=[float(t) for t in grid],
        mse_db_curve=[float(m) for m in mses],
        oracle_theta=oracle_theta,
        oracle_mse_db=oracle_mse,
    )
    if theta_EB is not None:
        eb_mses, _, _ = oracle_sweep(problem, [theta_EB], sigma2, cfg.salsa)
        out["eb_mse_db"] = float(eb_mses[0])

    if args.tau_grid > 0:
        # direct Tau_op sweep (salsa_m.m:234-280): raw tau, no theta*sigma2
        # coupling; default range spans the theta box times sigma2_true
        s2_true = float(problem.sigma_true) ** 2
        t_lo = args.tau_min if args.tau_min is not None else cfg.theta.box[0] * s2_true
        t_hi = args.tau_max if args.tau_max is not None else cfg.theta.box[1] * s2_true
        tgrid = np.exp(np.linspace(np.log(t_lo), np.log(t_hi), args.tau_grid))
        tmses, oracle_tau, oracle_tau_mse = tau_sweep(problem, tgrid, cfg.salsa)
        out.update(
            tau_grid=[float(t) for t in tgrid],
            tau_mse_db_curve=[float(m) for m in tmses],
            oracle_tau=oracle_tau,
            oracle_tau_mse_db=oracle_tau_mse,
        )
        if theta_EB is not None:
            out["tau_EB"] = float(theta_EB * sigma2)

    if args.sigma_grid > 0:
        # σ² sweep at the best theta (salsa_m_sigma.m:196-234 capability):
        # tau = theta * sigma2 over a log-grid spanning the BSNR-derived box
        th = out.get("theta_EB") or oracle_theta
        s_lo, s_hi = (float(problem.sigma2_box[0]), float(problem.sigma2_box[1]))
        sgrid = np.exp(np.linspace(np.log(s_lo), np.log(s_hi), args.sigma_grid))
        smses = []
        for s2 in sgrid:
            m, _, _ = oracle_sweep(problem, [th], float(s2), cfg.salsa)
            smses.append(float(m[0]))
        i = int(np.argmin(smses))
        out.update(
            sigma2_grid=[float(s) for s in sgrid],
            sigma2_mse_db_curve=smses,
            oracle_sigma2=float(sgrid[i]),
            oracle_sigma2_mse_db=smses[i],
            sigma2_true=float(problem.sigma_true) ** 2,
        )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

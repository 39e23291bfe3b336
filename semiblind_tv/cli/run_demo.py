"""End-to-end demo driver — the reference's run_{Gaussian,laplace,moffat}_demo.m.

Pipeline (run_Gaussian_demo.m:91-301):
  load image → build problem (observation synthesis, Lipschitz, MYULA steps)
  → SAPG estimation of (theta, PSF params, sigma²)
  → SALSA MAP solve with the plugged-in EB estimates
  → MSE(dB)/SSIM/SNR vs ground truth → results JSON (+ optional trace plots)

Usage:
  python -m semiblind_tv.cli.run_demo --psf gaussian --image wheel \
      --samples 20000 --warmup 15000 --chains 1 --out results/gaussian
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv import metrics
from semiblind_tv.runtime import build_problem, preset
from semiblind_tv.runtime.cache import enable_persistent_cache
from semiblind_tv.runtime.checkpoint import save_results
from semiblind_tv.sapg import run_sapg
from semiblind_tv.solvers import salsa_tv
from semiblind_tv.utils import load_image


def run_demo(
    cfg,
    image: np.ndarray,
    key=None,
    n_chains: int = 1,
    dtype=jnp.float32,
    solver: str = "salsa",
    mesh=None,
    space_mesh=None,
    checkpoint_every=None,
    checkpoint_path=None,
):
    """Run the full experiment; returns a results dict mirroring the
    reference `results` struct plus final metrics.

    solver: 'salsa' (reference demos) or 'fista' (reference my_deblur_fista
    legacy path) for the MAP solve.
    mesh: optional ('data','chains') Mesh — runs the complete SAPG pipeline
    sharded over the mesh's chains axis (run_sapg's shard_map path).
    space_mesh: optional ('space',) Mesh — row-shards the single image over
    the mesh for the SAPG phase (the giant-image estimator
    parallel.spatial.run_sapg_spatial; one chain, fft_mode='dft' required;
    the MAP solve stays single-device)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    k_prob, k_sapg = jax.random.split(key)
    problem = build_problem(image, cfg, k_prob, dtype=dtype)

    t0 = time.perf_counter()
    if space_mesh is not None:
        from semiblind_tv.parallel.spatial import run_sapg_spatial

        sapg = run_sapg_spatial(problem, space_mesh, k_sapg,
                                checkpoint_every=checkpoint_every,
                                checkpoint_path=checkpoint_path)
    else:
        sapg = run_sapg(problem, k_sapg, n_chains=n_chains, mesh=mesh,
                        checkpoint_every=checkpoint_every,
                        checkpoint_path=checkpoint_path)
    sapg_time = time.perf_counter() - t0

    theta_EB = sapg.theta_EB
    sigma2_EB = sapg.sigma2_EB
    params_EB = {k: jnp.asarray(v, dtype) for k, v in sapg.psf_params_EB.items()}

    # MAP solve with the plugged-in estimates (run_Gaussian_demo.m:209-242):
    # tau = theta_EB * sigma2_EB, mu = theta_EB/10
    H_EB = problem.blur.otf_host(problem.model.kernel(params_EB))
    t0 = time.perf_counter()
    if solver == "fista":
        from semiblind_tv.solvers import fista_tv

        salsa = fista_tv(
            problem.y,
            H_EB,
            tau=theta_EB * sigma2_EB,
            blur=problem.blur,
            tv_iters=cfg.salsa.tv_iters,
            max_iter=cfg.salsa.outer_iters,
            tol=cfg.salsa.tol,
            x_true=problem.x_true,
        )
        salsa.op_counts = {"A": 2 * salsa.n_iters, "AT": salsa.n_iters}
    else:
        salsa = salsa_tv(
            problem.y,
            H_EB,
            tau=theta_EB * sigma2_EB,
            mu=theta_EB * cfg.salsa.mu_factor,
            blur=problem.blur,
            max_iter=cfg.salsa.outer_iters,
            tol=cfg.salsa.tol,
            tv_iters=cfg.salsa.tv_iters,
            stop_criterion=cfg.salsa.stop_criterion,
            x_true=problem.x_true,
        )
    salsa_time = time.perf_counter() - t0

    x_map = salsa.x
    x_true = np.asarray(problem.x_true)
    results = {
        "psf": cfg.psf,
        "theta_EB": theta_EB,
        "sigma2_EB": sigma2_EB,
        "psf_params_EB": {k: float(v) for k, v in sapg.psf_params_EB.items()},
        "true_psf_params": cfg.true_psf_params(),
        "sigma2_true": float(problem.sigma_true) ** 2,
        "mse_db": float(metrics.mse_db(jnp.asarray(x_true), jnp.asarray(x_map))),
        "ssim": float(metrics.ssim(jnp.asarray(x_true), jnp.asarray(x_map))),
        "snr_db": float(metrics.snr(jnp.asarray(x_true), jnp.asarray(x_map))),
        "psnr_db": float(metrics.psnr(jnp.asarray(x_true), jnp.asarray(x_map))),
        "mse_db_observation": float(
            metrics.mse_db(jnp.asarray(x_true), problem.y)
        ),
        "sapg_time_s": sapg_time,
        "salsa_time_s": salsa_time,
        "salsa_iters": salsa.n_iters,
        "salsa_op_counts": salsa.op_counts,
        "n_chains": n_chains,
        "samples": cfg.sapg.samples,
        "warmup": cfg.sapg.warmup,
        "lambda": float(problem.lambda_myula),
        "gamma": float(problem.gamma),
        "Lf": float(problem.Lf),
        "ev_max": float(problem.ev_max),
    }
    return results, sapg, salsa, problem


def save_plots(out_dir, results, sapg, salsa, problem):
    """Reproduce the reference figure set (run_Gaussian_demo.m:248-301)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)

    def trace_fig(name, trace, true_val=None, ylabel=None):
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(trace, "b", lw=1.2, label=f"${name}_n$")
        if true_val is not None:
            ax.axhline(true_val, color="r", ls="--", label=f"${name}" + r"_{true}$")
        ax.set_xlabel("Iteration (n)")
        ax.set_ylabel(ylabel or name)
        ax.grid(True)
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"trace_{name}.png"), dpi=120)
        plt.close(fig)

    trace_fig("sigma2", sapg.sigma2s, results["sigma2_true"])
    trace_fig("theta", sapg.thetas)
    for pname, tr in sapg.psf_param_traces.items():
        trace_fig(pname, tr, results["true_psf_params"].get(pname))
    trace_fig("logPi", sapg.logPiTrace)
    trace_fig("err_psf", sapg.err_psf)

    panels = [
        ("x", np.asarray(problem.x_true)),
        ("y", np.asarray(problem.y)),
        ("xMAP", salsa.x),
    ]
    if getattr(sapg, "posterior_mean", None) is not None:
        # the reference's commented-out figmean panel (run_Gaussian_demo.m:291-295)
        panels.append(("posterior_mean", sapg.posterior_mean[0]))
        panels.append(("posterior_std", np.sqrt(sapg.posterior_var[0])))
    for title, img in panels:
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(img, cmap="gray")
        ax.set_axis_off()
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"img_{title}.png"), dpi=120)
        plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--bsnr", type=float, default=30.0)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--plots", action="store_true")
    p.add_argument("--solver", choices=["salsa", "fista"], default="salsa",
                   help="MAP solver: salsa (demos) or fista (legacy my_deblur_fista)")
    p.add_argument("--no-fix-w", action="store_true",
                   help="gaussian: estimate w1/w2 instead of pinning to truth")
    p.add_argument("--fft-mode", choices=["fft", "dft"], default=None,
                   help="hot-loop transform backend: jnp.fft (cuFFT) or matmul-DFT")
    p.add_argument("--sigma-log-scale", action="store_true",
                   help="EXTENSION: log-space sigma^2 SA updates — moves far "
                        "faster from the wide BSNR-midpoint init at 512^2 "
                        "(the reference's linear update barely moves there, "
                        "RESULTS.md); off = reference dynamics")
    p.add_argument("--psf-log-scale", action="store_true",
                   help="EXTENSION: log-space SA updates for the free PSF "
                        "parameters (probe for the degenerate w1/beta axes); "
                        "off = reference linear dynamics")
    p.add_argument("--mesh", default=None, metavar="DxC",
                   help="run the SAPG phase sharded on a data x chains device "
                        "mesh, e.g. --mesh 1x8 (requires chains %% C == 0)")
    p.add_argument("--space-mesh", type=int, default=None, metavar="S",
                   help="row-shard the image over a ('space',) mesh of S "
                        "devices for the SAPG phase (giant-image estimator "
                        "run_sapg_spatial; forces fft_mode=dft, one chain); "
                        "needs S devices")
    args = p.parse_args(argv)
    enable_persistent_cache()

    kwargs = {}
    if args.psf == "gaussian" and args.no_fix_w:
        kwargs.update(fix_w1=False, fix_w2=False)
    cfg = preset(args.psf, **kwargs)
    cfg = dataclasses.replace(cfg, bsnr=args.bsnr, seed=args.seed, image=args.image)
    sapg_over = {}
    if args.samples is not None:
        sapg_over["samples"] = args.samples
        sapg_over["burn_in"] = (args.samples * 80) // 100
    if args.warmup is not None:
        sapg_over["warmup"] = args.warmup
    if args.fft_mode is not None:
        sapg_over["fft_mode"] = args.fft_mode
    if args.sigma_log_scale:
        sapg_over["sigma_log_scale"] = True
    if args.psf_log_scale:
        sapg_over["psf_log_scale"] = True
    space_mesh = None
    if args.space_mesh:
        # the spatial estimator contracts its transforms with the host-side
        # DFT factor matrices (parallel/spatial.py) — force the dft backend
        sapg_over["fft_mode"] = "dft"
        if len(jax.devices()) < args.space_mesh:
            raise RuntimeError(
                f"--space-mesh {args.space_mesh} needs {args.space_mesh} "
                f"devices; {jax.default_backend()} has {len(jax.devices())}"
            )
        from semiblind_tv.parallel.mesh import make_spatial_mesh

        space_mesh = make_spatial_mesh(args.space_mesh)
    if sapg_over:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg_over))

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    mesh = None
    if args.mesh is not None:
        from semiblind_tv.parallel.mesh import make_mesh

        d, c = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_mesh(data=d, chains=c)
        if args.chains % c != 0:
            args.chains = c  # one chain per chains-shard by default

    image = load_image(args.image, args.image_dir, size=args.size)
    results, sapg, salsa, problem = run_demo(
        cfg, image, n_chains=args.chains, dtype=dtype, solver=args.solver,
        mesh=mesh, space_mesh=space_mesh,
    )

    print(json.dumps(results, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        save_results(os.path.join(args.out, "traces.npz"), sapg, salsa)
        if args.plots:
            save_plots(args.out, results, sapg, salsa, problem)
    return results


if __name__ == "__main__":
    main()

"""Generic SAPG estimator — the fused accelerator hot loop.

One estimator replaces the reference's three near-duplicate files
(`SAPG/SAPG_algorithm_Guassian.m:7-308`, `SAPG_algorithm_laplace.m:7-268`,
`SAPG_algorithm_moffat.m:7-297`): the PSF family enters as a `PsfModel`
and the per-parameter policies as `ParamSpec`s.

Algorithm (reference SAPG_algorithm_Guassian.m):
  warm-up:  `warmup` MYULA steps at fixed hyperparameters          (:67-93)
  main:     for ii = 2..samples
              X ← MYULA step (prox carried from previous iter)      (:158-162)
              G_θ = d/θ − TV(X);     θ ← clip(θ + c_θ δ(ii) G_θ)    (:165-167)
              G_p = ⟨∂_p A X, AX−y⟩/σ²;  p ← clip(p − c_p δ(ii) G_p) (:170-185)
              G_σ = ‖AX−y‖²/2σ⁴ − d/2σ²; σ² ← clip(σ² + c_σ δ(ii) G_σ) (:188-194)
            δ(ii) = d_scale · ii^(−d_exp) / d                        (:55)
  EB estimates = mean of iterates over [burnIn, samples]             (:258-290)

Fusion (the reason this exists): per iteration the reference
spends ~12 full 512² FFTs (A, Aᵀ, and one inverse FFT per hyper-gradient).
Here the scan carries rfft2(X); residual and all hyper-gradients are
evaluated on the rfft half-spectrum via Parseval, and the OTFs of the
(changing) PSF and its parameter gradients are computed by tiny DFT
matmuls.  Total transform cost: ONE rfft2 + ONE irfft2 per iteration.

Chains: the estimator runs `n_chains` independent MYULA chains (vmapped on
chip); the per-chain SA statistics are averaged — and `lax.pmean`-reduced
over `axis_name` when running under shard_map — before the (replicated)
hyperparameter update.  n_chains=1 reproduces the reference trajectory
class exactly.

Diagnostics (burn-in running means, relative-change tolerances, PSF
L2-error traces) are *pure functions of the scalar traces* and are
reconstructed post-hoc in O(n) — the MATLAB code recomputes O(n) means
inside the loop (SAPG_algorithm_Guassian.m:218-247).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops.tv import chambolle_prox, tv_norm
from semiblind_tv.runtime.checkpoint import load_checkpoint_arrays, save_checkpoint_arrays
from semiblind_tv.runtime.problem import Problem
from semiblind_tv.samplers.myula import myula_kernel_step

__all__ = [
    "SAPGResult",
    "SAPGDivergenceError",
    "run_sapg",
    "make_sapg_step",
    "make_general_sapg_step",
    "problem_consts",
    "run_segmented_scan",
    "assemble_result",
]


class SAPGDivergenceError(RuntimeError):
    """Raised by the fail-fast guard when a scan segment produces non-finite
    traces (diverged chain / hardware fault) and no recovery is possible.

    The reference has no failure handling at all (SURVEY.md §5 —
    failure-detection row); this is new supervision: a diverged
    chain would otherwise silently burn the remaining iteration budget.
    """


@dataclasses.dataclass
class SAPGResult:
    """Mirror of the reference `results` struct (SAPG_algorithm_Guassian.m:250-306)."""

    theta_EB: float
    sigma2_EB: float
    psf_params_EB: Dict[str, float]
    thetas: np.ndarray
    sigma2s: np.ndarray
    psf_param_traces: Dict[str, np.ndarray]
    logPiTrace: np.ndarray          # logPiTraceX
    logPiTrace_warmup: np.ndarray   # logPiTrace_WU
    gX: np.ndarray                  # regulariser trace (shifted like the reference)
    grad_theta: np.ndarray
    grad_sigma: np.ndarray
    grad_psf: Dict[str, np.ndarray]
    mean_thetas: np.ndarray
    mean_sigma2s: np.ndarray
    mean_psf: Dict[str, np.ndarray]
    tol_thetas: np.ndarray
    tol_sigma2s: np.ndarray
    tol_psf: Dict[str, np.ndarray]
    err_psf: np.ndarray
    X_last: np.ndarray              # (n_chains, M, N)
    last_samp: int
    exec_time: float
    posterior_mean: Optional[np.ndarray] = None  # Welford over post-burn-in
    posterior_var: Optional[np.ndarray] = None   # samples (per chain)

    @property
    def last_theta(self):
        return float(self.thetas[-1])


def _running_window_stats(trace: np.ndarray, burn_in: int, log_scale: bool = False):
    """Running means over [burnIn, ii] and their relative-change tolerances.

    trace is 0-based with trace[0] the init (MATLAB index 1).  Returns
    (mean_trace, tol_trace, eb) with mean_trace of length len-burn_in
    (MATLAB mean_* arrays) and tol_trace of length len (zeros before the
    window has ≥2 entries, where MATLAB stores NaN from empty windows).

    log_scale: average in eta = log(theta) space and exponentiate — the
    Algorithm-1 EB estimate exp(mean(eta)) (SALSA/SAPG_algorithm_1.m:227).
    """
    n = len(trace)
    window = np.log(trace[burn_in - 1 :]) if log_scale else trace[burn_in - 1 :]
    cums = np.cumsum(window)
    counts = np.arange(1, len(window) + 1)
    running = cums / counts
    if log_scale:
        running = np.exp(running)
    eb = float(running[-1])
    mean_trace = running[1:]
    tol = np.zeros(n)
    prev = running[:-1]
    cur = running[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(cur - prev) / prev
    tol[burn_in:] = rel
    return mean_trace, tol, eb


def make_general_sapg_step(
    model,
    blur,
    cfg,
    sigma_fix: bool,
    sigma_fix_value: Optional[float],
    axis_name: Optional[str] = None,
):
    """Build the fused per-iteration SAPG step as a pure function of
    (carry, ii, consts), where `consts` holds the per-problem quantities:

      consts = dict(yhat, gam, lam, sigma2_lo, sigma2_hi, sigma2_init)

    This form vmaps over a batch of problems (data parallelism) and runs
    under shard_map with `axis_name` naming the chains mesh axis (the
    per-chain SA statistics are lax.pmean-reduced over it).
    """
    sapg = cfg.sapg
    dtype = blur.dtype
    d = blur.dim
    w = blur.weights

    theta_spec = cfg.theta
    psf_specs = cfg.psf_params
    psf_names = tuple(s.name for s in psf_specs)
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / theta_spec.init

    # only non-fixed params need OTF gradients; with every PSF param pinned
    # (the reference's published Gaussian config, run_Gaussian_demo.m:42-43)
    # the OTF is a loop constant and the per-iteration kernel+DFT matmul is
    # hoisted out of the scan entirely (H0_c below is a host-side closure
    # constant, like the warm-up's)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    all_fixed = not free_names

    def otfs(params):
        k, dks = model.kernel_and_grads(params)
        stack = jnp.stack([k] + [dks[n] for n in free_names])
        Hs = blur.otf_batched(stack)  # one batched matmul pair for all OTFs
        return Hs[0], {n: Hs[i + 1] for i, n in enumerate(free_names)}

    def pnorm2(Rhat):
        re, im = Rhat.real, Rhat.imag
        return jnp.sum(w[None] * (re * re + im * im), axis=(-2, -1)) / d

    def pdot(Ahat, Bhat):
        return jnp.sum(w[None] * (Ahat * jnp.conj(Bhat)).real, axis=(-2, -1)) / d

    tv_b = jax.vmap(tv_norm)

    def prox_b(X, lam_theta):
        return jax.vmap(
            lambda g: chambolle_prox(
                g,
                lam_theta,
                sapg.chambolle_iters,
                tau=sapg.chambolle_tau,
                tol=sapg.chambolle_tol,
            )
        )(X)

    def reduce_stat(s):
        s = jnp.mean(s)
        if axis_name is not None:
            s = jax.lax.pmean(s, axis_name)
        return s

    def chain_noise(keys, shape):
        """Per-chain key split + draw — layout-invariant across shardings."""
        ks = jax.vmap(jax.random.split)(keys)
        new_keys, subs = ks[:, 0], ks[:, 1]
        Z = jax.vmap(lambda k: jax.random.normal(k, shape, dtype))(subs)
        return new_keys, Z

    burn_in_static = sapg.burn_in_resolved

    def step(carry, ii, consts):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        X, Xhat, prox, keys, theta, sigma2, params, extra = carry
        H, dHs = (H0_c, {}) if all_fixed else otfs(params)
        Rhat = H[None] * Xhat - yhat[None]

        keys, Z = chain_noise(keys, X.shape[1:])
        gradF = blur.irfft(jnp.conj(H)[None] * Rhat) / sigma2
        Xn = myula_kernel_step(X, prox, gradF, gam, lam, Z, sapg.positivity)
        proxn, _ = prox_b(Xn, lam * theta)
        Xhatn = blur.rfft(Xn)
        Rn = H[None] * Xhatn - yhat[None]
        res2 = pnorm2(Rn)
        tv = tv_b(Xn)

        G_t = reduce_stat(d / theta - tv)
        G_s = reduce_stat(res2 / (2.0 * sigma2**2) - d / (2.0 * sigma2))
        # hyper-gradients only for free params (reference computes G_w only
        # inside `if ~fix_w*`, SAPG_algorithm_Guassian.m:170-185); fixed
        # params trace a zero gradient
        G_p = {n: reduce_stat(pdot(dHs[n][None] * Xhatn, Rn) / sigma2) for n in free_names}
        zero = jnp.zeros_like(G_t)

        delta_i = d_scale * ii.astype(dtype) ** (-sapg.d_exp) / d
        if sapg.theta_log_scale:
            # Algorithm-1: eta = log(theta), eta += delta * G_t * exp(eta),
            # clipped in eta-space (SALSA/SAPG_algorithm_1.m:180-182)
            eta = jnp.log(theta)
            eta_n = jnp.clip(
                eta + theta_spec.step_scale * delta_i * G_t * theta,
                jnp.log(theta_spec.box[0]),
                jnp.log(theta_spec.box[1]),
            )
            theta_n = jnp.exp(eta_n)
        else:
            theta_n = theta_spec.clip(theta + theta_spec.step_scale * delta_i * G_t)
        params_n = {}
        for s in psf_specs:
            if s.fix:
                cand = jnp.asarray(s.true_value, dtype)
                params_n[s.name] = s.clip(cand)
            elif sapg.psf_log_scale:
                # EXTENSION (opt-in, mirrors sigma_log_scale): log-space SA
                # update with the chain-rule factor p, clipped in log space.
                # Probe for the degenerate axes (w1 on wheel, Moffat beta);
                # the reference's linear update stays the default
                lp = jnp.log(params[s.name])
                lp_n = jnp.clip(
                    lp + s.sign * s.step_scale * delta_i * G_p[s.name]
                    * params[s.name],
                    jnp.log(jnp.asarray(s.box[0], dtype)),
                    jnp.log(jnp.asarray(s.box[1], dtype)),
                )
                params_n[s.name] = jnp.exp(lp_n)
            else:
                cand = params[s.name] + s.sign * s.step_scale * delta_i * G_p[s.name]
                params_n[s.name] = s.clip(cand)
        if sigma_fix:
            sigma_n = consts["sigma2_init"]
        elif sapg.sigma_log_scale:
            # optional extension (not in the reference): update log σ² with
            # the chain-rule factor σ², clipped in log space — converges far
            # faster from the wide BSNR-midpoint init at large d, where the
            # reference's linear update barely moves (see RESULTS.md)
            lsig = jnp.log(sigma2)
            lsig_n = jnp.clip(
                lsig + cfg.sigma_step_scale * delta_i * G_s * sigma2,
                jnp.log(consts["sigma2_lo"]),
                jnp.log(consts["sigma2_hi"]),
            )
            sigma_n = jnp.exp(lsig_n)
        else:
            sigma_n = jnp.clip(
                sigma2 + cfg.sigma_step_scale * delta_i * G_s,
                consts["sigma2_lo"],
                consts["sigma2_hi"],
            )

        logpi = reduce_stat(-res2 / (2.0 * sigma2) - theta * tv)
        trace = dict(
            theta=theta_n,
            sigma2=sigma_n,
            logPi=logpi,
            gX=reduce_stat(tv),
            G_t=G_t,
            G_s=G_s,
            **{f"G_{n}": G_p.get(n, zero) for n in psf_names},
            **{n: params_n[n] for n in psf_names},
        )
        if sapg.track_posterior_moments:
            # Welford running posterior mean/variance over post-burn-in
            # samples (the reference's commented-out weldford intent)
            take = (ii > burn_in_static).astype(dtype)
            cnt = extra["pm_count"] + take
            dX = Xn - extra["pm_mean"]
            mean_n = extra["pm_mean"] + take * dX / jnp.maximum(cnt, 1.0)
            m2_n = extra["pm_m2"] + take * dX * (Xn - mean_n)
            extra = dict(pm_mean=mean_n, pm_m2=m2_n, pm_count=cnt)

        return (Xn, Xhatn, proxn, keys, theta_n, sigma_n, params_n, extra), trace

    # --- warm-up step: MYULA at the fixed initial hyperparameters ---------
    # (SAPG_algorithm_Guassian.m:67-93).  The initial params are config
    # constants, so the warm-up OTF is baked in at build time.
    theta0_c = jnp.asarray(theta_spec.init, dtype)
    params0_c = {k: jnp.asarray(v, dtype) for k, v in cfg.init_psf_params().items()}
    H0_c = blur.otf_host(model.kernel(params0_c))  # host: jit-closure constant

    def warm_step(carry, _, consts):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        sigma0 = consts["sigma2_init"]
        X, Xhat, prox, keys = carry
        Rhat = H0_c[None] * Xhat - yhat[None]
        keys, Z = chain_noise(keys, X.shape[1:])
        gradF = blur.irfft(jnp.conj(H0_c)[None] * Rhat) / sigma0
        Xn = myula_kernel_step(X, prox, gradF, gam, lam, Z)
        proxn, _ = prox_b(Xn, lam * theta0_c)
        tv = tv_b(Xn)
        Xhatn = blur.rfft(Xn)
        res2 = pnorm2(H0_c[None] * Xhatn - yhat[None])
        logpi = reduce_stat(-res2 / (2.0 * sigma0) - theta0_c * tv)
        return (Xn, Xhatn, proxn, keys), logpi

    aux = dict(
        psf_names=psf_names,
        theta_spec=theta_spec,
        psf_specs=psf_specs,
        d_scale=d_scale,
        prox_b=prox_b,
        tv_b=tv_b,
        pnorm2=pnorm2,
        otfs=otfs,
        warm_step=warm_step,
        theta0=theta0_c,
        params0=params0_c,
        H0=H0_c,
    )
    return step, aux


def problem_consts(problem: Problem):
    """The per-problem constants consumed by the general SAPG step."""
    return dict(
        yhat=problem.yhat,
        gam=problem.gamma,
        lam=problem.lambda_myula,
        sigma2_lo=problem.sigma2_box[0],
        sigma2_hi=problem.sigma2_box[1],
        sigma2_init=problem.sigma2_init,
    )


def make_sapg_step(problem: Problem, n_chains: int, axis_name: Optional[str] = None):
    """Per-problem SAPG step: (carry, ii) -> (carry, trace), scan-compatible.

    Thin wrapper over make_general_sapg_step with this problem's constants
    bound.  Exposed so benchmarks and the multi-chip dry-run can jit exactly
    the hot loop body."""
    cfg = problem.cfg
    sigma_spec = problem.sigma_spec()
    gstep, aux = make_general_sapg_step(
        problem.model,
        problem.blur,
        cfg,
        sigma_fix=sigma_spec.fix,
        sigma_fix_value=sigma_spec.true_value,
        axis_name=axis_name,
    )
    consts = problem_consts(problem)

    def step(carry, ii):
        return gstep(carry, ii, consts)

    aux = dict(aux, lam=problem.lambda_myula, gam=problem.gamma, sigma_spec=sigma_spec)
    return step, aux


def _save_checkpoint(path: str, carry, done_iters: int, seg_traces,
                     logpi_wu, logpi0, backend: str = "npz") -> None:
    """Persist (carry, completed-iteration count, trace segments, warm-up
    trace).

    Xhat is complex and recomputable — dropped; PRNG keys stored via
    key_data.  The warm-up
    trace (logpi_wu, logpi0) rides along so a resumed run can SKIP the
    warm-up phase entirely (15k iterations — 43% of the reference budget).
    `backend` selects NPZ (portable default) or Orbax
    (multi-host-coordinated) via runtime.checkpoint.save_checkpoint_arrays.
    """
    X, _Xhat, prox, keys, theta, sigma2, params, extra = carry
    merged = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *seg_traces)
    arrays = {f"trace/{k}": v for k, v in merged.items()}
    arrays.update(
        X=np.asarray(X),
        prox=np.asarray(prox),
        keys=np.asarray(jax.random.key_data(keys)),
        theta=np.asarray(theta),
        sigma2=np.asarray(sigma2),
        done_iters=np.asarray(done_iters),
        logpi_wu=np.asarray(logpi_wu),
        logpi0=np.asarray(logpi0),
    )
    for k, v in params.items():
        arrays[f"param/{k}"] = np.asarray(v)
    for k, v in extra.items():
        arrays[f"extra/{k}"] = np.asarray(v)
    save_checkpoint_arrays(path, arrays, backend=backend)


def _restore_checkpoint(path: str, backend: str | None = None,
                        rfft=jnp.fft.rfft2):
    """Inverse of _save_checkpoint; returns
    (carry, done_iters, [trace dict], logpi_wu, logpi0).

    `rfft` recomputes the dropped Xhat and must match the run's transform
    mode (blur.rfft) so a resumed trajectory equals an uninterrupted one."""
    z = load_checkpoint_arrays(path, backend=backend)
    X = jnp.asarray(z["X"])
    prox = jnp.asarray(z["prox"])
    keys = jax.random.wrap_key_data(jnp.asarray(z["keys"]))
    theta = jnp.asarray(z["theta"])
    sigma2 = jnp.asarray(z["sigma2"])
    params = {k[len("param/"):]: jnp.asarray(z[k]) for k in z if k.startswith("param/")}
    traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
    extra = {k[len("extra/"):]: jnp.asarray(z[k]) for k in z if k.startswith("extra/")}
    done = int(z["done_iters"])
    carry = (X, rfft(X), prox, keys, theta, sigma2, params, extra)
    return carry, done, [traces], z["logpi_wu"], z["logpi0"]


def _traces_finite(tr) -> bool:
    """Fail-fast divergence check on a segment's scalar traces."""
    for name in ("logPi", "theta", "sigma2"):
        if name in tr and not np.all(np.isfinite(tr[name])):
            return False
    return True


def run_segmented_scan(
    scan_seg,
    carry,
    samples: int,
    *,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    save_fn=None,
    restore_fn=None,
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
):
    """Drive the segmented main SAPG scan with checkpointing + supervision.

    Shared between the single-device (`run_sapg`) and sharded
    (`parallel.sapg_parallel.run_sapg_sharded`) estimators:

      * segments the scan every `checkpoint_every` iterations and calls
        `save_fn(carry, done_iters, seg_traces)` after each segment;
      * resumes from an existing checkpoint via
        `restore_fn() -> (carry, done_iters, [trace dicts])`;
      * fail-fast NaN guard (new capability — SURVEY.md §5 failure-detection
        row): if a segment's logPi/theta/sigma2 traces go non-finite (e.g. a
        transient hardware fault corrupted the carry), auto-restores from the
        last good checkpoint and re-runs, up to `max_restores` times, then
        raises SAPGDivergenceError;
      * `fault_hook(seg_idx, carry) -> carry` is the fault-injection point
        used by the recovery tests (called before each segment).

    Returns (carry, seg_traces) where seg_traces is a list of host-side
    trace dicts (one per completed segment, resumed segments included).
    """
    seg_traces = []
    start_ii = 2
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        carry, done, saved = restore_fn()
        start_ii += done
        seg_traces.extend(saved)

    def _host(tr):
        return jax.tree_util.tree_map(np.asarray, tr)

    if checkpoint_every is None:
        if start_ii <= samples:
            carry, tr = scan_seg(carry, jnp.arange(start_ii, samples + 1))
            tr = _host(tr)
            if nan_guard and not _traces_finite(tr):
                raise SAPGDivergenceError(
                    f"non-finite SAPG traces in iterations [{start_ii}, {samples}] "
                    "(no checkpoint to restore from)"
                )
            seg_traces.append(tr)
        return carry, seg_traces

    ii = start_ii
    seg_idx = 0
    restores = 0
    while ii <= samples:
        if fault_hook is not None:
            carry = fault_hook(seg_idx, carry)
        end = min(ii + checkpoint_every - 1, samples)
        carry_try, tr = scan_seg(carry, jnp.arange(ii, end + 1))
        tr = _host(tr)
        seg_idx += 1
        if nan_guard and not _traces_finite(tr):
            can_restore = (
                restores < max_restores
                and checkpoint_path is not None
                and os.path.exists(checkpoint_path)
            )
            if not can_restore:
                raise SAPGDivergenceError(
                    f"non-finite SAPG traces in iterations [{ii}, {end}]; "
                    f"restores exhausted ({restores}/{max_restores})"
                )
            restores += 1
            carry, done, saved = restore_fn()
            seg_traces = list(saved)
            ii = 2 + done
            continue
        carry = carry_try
        seg_traces.append(tr)
        ii = end + 1
        if checkpoint_path is not None:
            save_fn(carry, ii - 2, seg_traces)
    return carry, seg_traces


def assemble_result(
    problem: Problem,
    psf_names,
    traces: Dict[str, np.ndarray],
    logpi_wu: np.ndarray,
    logpi0: float,
    X_last: np.ndarray,
    extra_out: Dict,
    exec_time: float,
) -> SAPGResult:
    """Host-side post-processing of the scalar traces into the reference
    `results` struct (SAPG_algorithm_Guassian.m:250-306).

    Pure function of per-problem 1-D traces — shared by the single-device
    and sharded estimators (the sharded runner slices its (T, D) traces per
    problem and calls this per data-shard)."""
    cfg = problem.cfg
    sapg = cfg.sapg
    burn_in = sapg.burn_in_resolved
    params0 = cfg.init_psf_params()

    def full_trace(name, init_val):
        return np.concatenate([[init_val], traces[name]])

    thetas = full_trace("theta", cfg.theta.init)
    sigma2s = full_trace("sigma2", float(problem.sigma2_init))
    psf_traces = {n: full_trace(n, float(params0[n])) for n in psf_names}

    mean_thetas, tol_thetas, theta_EB = _running_window_stats(
        thetas, burn_in, log_scale=sapg.theta_log_scale
    )
    mean_sigmas, tol_sigmas, sigma_EB = _running_window_stats(sigma2s, burn_in)
    mean_psf, tol_psf, psf_EB = {}, {}, {}
    for n in psf_names:
        mean_psf[n], tol_psf[n], psf_EB[n] = _running_window_stats(psf_traces[n], burn_in)

    err_psf = _psf_error_trace(problem, psf_traces)

    logPiTrace = np.concatenate([[float(logpi0)], traces["logPi"]])
    n_warm = len(logpi_wu)
    logPiTrace_WU = (
        np.concatenate([[0.0], np.asarray(logpi_wu)]) if n_warm > 0 else np.zeros(0)
    )
    # the reference stores g(X_ii) at index ii-1 and leaves the last slot 0
    gX = np.concatenate([traces["gX"], [0.0]])

    if sapg.track_posterior_moments and extra_out:
        pm_mean = np.asarray(extra_out["pm_mean"])
        cnt = float(extra_out["pm_count"])
        pm_var = np.asarray(extra_out["pm_m2"]) / max(cnt - 1.0, 1.0)
    else:
        pm_mean = pm_var = None

    return SAPGResult(
        theta_EB=theta_EB,
        sigma2_EB=sigma_EB,
        psf_params_EB=psf_EB,
        thetas=thetas,
        sigma2s=sigma2s,
        psf_param_traces=psf_traces,
        logPiTrace=logPiTrace,
        logPiTrace_warmup=logPiTrace_WU,
        gX=gX,
        grad_theta=np.concatenate([[0.0], traces["G_t"]]),
        grad_sigma=np.concatenate([[0.0], traces["G_s"]]),
        grad_psf={n: np.concatenate([[0.0], traces[f"G_{n}"]]) for n in psf_names},
        mean_thetas=mean_thetas,
        mean_sigma2s=mean_sigmas,
        mean_psf=mean_psf,
        tol_thetas=tol_thetas,
        tol_sigma2s=tol_sigmas,
        tol_psf=tol_psf,
        err_psf=err_psf,
        X_last=np.asarray(X_last),
        last_samp=sapg.samples,
        exec_time=exec_time,
        posterior_mean=pm_mean,
        posterior_var=pm_var,
    )


def run_sapg(
    problem: Problem,
    key,
    n_chains: int = 1,
    axis_name: Optional[str] = None,
    x0: Optional[jnp.ndarray] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_backend: str = "npz",
    mesh=None,
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
) -> SAPGResult:
    """Run warm-up + SAPG and assemble the full diagnostics bundle.

    checkpoint_every/checkpoint_path enable mid-run checkpoint + resume:
    the scan is segmented, the carry persisted after each segment, and an
    existing checkpoint at `checkpoint_path` resumes the run mid-way
    (identical trajectory to an uninterrupted run — tested).
    checkpoint_backend: "npz" (single-file, portable) or "orbax"
    (directory per checkpoint, async multi-host-coordinated writes).

    mesh: a ('data', 'chains') jax.sharding.Mesh (data axis size 1) routes
    the ENTIRE run — warm-up, main scan, checkpointing, EB assembly —
    through the shard_map production path with the n_chains chains sharded
    over the mesh's chains axis.  Per-chain PRNG keys make the trajectory
    equal to the single-device run up to cross-chain reduction order
    (tested at 1e-12 relative in f64).

    nan_guard/max_restores/fault_hook: fail-fast divergence supervision —
    see run_segmented_scan."""
    if mesh is not None:
        from semiblind_tv.parallel.mesh import CHAINS_AXIS
        from semiblind_tv.parallel.sapg_parallel import run_sapg_sharded

        S = mesh.shape[CHAINS_AXIS]
        if n_chains % S != 0:
            raise ValueError(f"n_chains={n_chains} not divisible by mesh chains axis {S}")
        return run_sapg_sharded(
            [problem],
            mesh,
            key,
            chains_per_shard=n_chains // S,
            x0=x0,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
            checkpoint_backend=checkpoint_backend,
            fault_hook=fault_hook,
            nan_guard=nan_guard,
            max_restores=max_restores,
        )[0]
    cfg = problem.cfg
    sapg = cfg.sapg
    blur = problem.blur
    dtype = blur.dtype
    d = problem.dim
    yhat = problem.yhat

    step, aux = make_sapg_step(problem, n_chains, axis_name)
    psf_names = aux["psf_names"]
    prox_b, tv_b, pnorm2 = aux["prox_b"], aux["tv_b"], aux["pnorm2"]
    lam, gam = aux["lam"], aux["gam"]

    theta0 = jnp.asarray(cfg.theta.init, dtype)
    sigma0 = jnp.asarray(problem.sigma2_init, dtype)
    params0 = {k: jnp.asarray(v, dtype) for k, v in cfg.init_psf_params().items()}

    if x0 is None:
        x0 = problem.y  # op.X0 defaults to y (SAPG_algorithm_Guassian.m:10-12)
    X0 = jnp.broadcast_to(x0, (n_chains,) + tuple(blur.shape)).astype(dtype)

    H0 = blur.otf_host(problem.model.kernel(params0))
    consts = problem_consts(problem)
    warm_step = aux["warm_step"]

    n_warm = max(sapg.warmup - 1, 0)
    n_main = sapg.samples - 1

    def _warm(X0, key):
        keys = jax.random.split(key, n_chains)
        prox0, _ = prox_b(X0, lam * theta0)
        Xhat0 = blur.rfft(X0)
        carry0 = (X0, Xhat0, prox0, keys)
        if n_warm > 0:
            carry0, logpi_wu = jax.lax.scan(
                lambda c, x: warm_step(c, x, consts), carry0, None, length=n_warm
            )
        else:
            logpi_wu = jnp.zeros((0,), dtype)
        X, Xhat, prox, keys = carry0
        # logPiTraceX(1) = logPi at the warm-start sample with the init params
        res2_0 = pnorm2(H0[None] * Xhat - yhat[None])
        logpi0 = jnp.mean(-res2_0 / (2.0 * sigma0) - theta0 * tv_b(X))
        if sapg.track_posterior_moments:
            extra0 = dict(
                pm_mean=jnp.zeros_like(X),
                pm_m2=jnp.zeros_like(X),
                pm_count=jnp.zeros((), dtype),
            )
        else:
            extra0 = {}
        carry = (X, Xhat, prox, keys, theta0, sigma0, params0, extra0)
        return carry, logpi_wu, logpi0

    _main_seg = jax.jit(lambda c, iis: jax.lax.scan(step, c, iis))

    t0 = time.perf_counter()
    resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
    if resume:
        # the checkpoint carries the warm-up trace — skip the warm-up phase
        # entirely (it is 43% of the reference budget); restore_fn below
        # supplies the carry
        carry0 = logpi_wu = logpi0 = None
    else:
        carry0, logpi_wu, logpi0 = jax.jit(_warm)(X0, key)

    def _restore():
        nonlocal logpi_wu, logpi0
        carry, done, traces, logpi_wu, logpi0 = _restore_checkpoint(
            checkpoint_path, backend=checkpoint_backend,
            rfft=jax.jit(blur.rfft),
        )
        return carry, done, traces

    # Optional mid-run checkpointing + fail-fast supervision: the shared
    # segmented driver persists the carry every `checkpoint_every` iterations,
    # resumes from an existing checkpoint, and auto-restores on non-finite
    # traces (new capability; the reference has neither, SURVEY §5).
    carry, seg_traces = run_segmented_scan(
        _main_seg,
        carry0,
        sapg.samples,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path,
        save_fn=lambda c, done, segs: _save_checkpoint(
            checkpoint_path, c, done, segs, logpi_wu, logpi0,
            backend=checkpoint_backend,
        ),
        restore_fn=_restore,
        fault_hook=fault_hook,
        nan_guard=nan_guard,
        max_restores=max_restores,
    )
    traces = (
        jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *seg_traces)
        if len(seg_traces) > 1
        else seg_traces[0]
    )
    jax.block_until_ready(carry)
    exec_time = time.perf_counter() - t0

    # ---- host-side post-processing (pure functions of the scalar traces) ----
    traces = jax.tree_util.tree_map(np.asarray, traces)
    return assemble_result(
        problem,
        psf_names,
        traces,
        np.asarray(logpi_wu) if n_warm > 0 else np.zeros(0),
        float(logpi0),
        carry[0],
        carry[7],
        exec_time,
    )


def _psf_error_trace(problem: Problem, psf_traces: Dict[str, np.ndarray]) -> np.ndarray:
    """PSF L2-error trace vs the true kernel, reconstructed from the traces.

    The reference's `l2` is `norm(x-y)^2` on a 7x7 matrix — the MATLAB
    matrix 2-norm, i.e. the *spectral* norm, squared (utils/l2.m:1-3).

    Per-family index quirks preserved:
      * gaussian: psf_gaussian(size, w1s(ii), w2s(ii-1)) — new w1, OLD w2
        (SAPG_algorithm_Guassian.m:203)
      * laplace:  psf_laplace(size, bs(ii))              (_laplace.m:189)
      * moffat:   psf_moffat(size, alphas(ii), betas(ii)) (_moffat.m:205)
    """
    model = problem.model
    names = list(psf_traces)
    T = len(next(iter(psf_traces.values())))
    args = {}
    for n in names:
        args[n] = jnp.asarray(psf_traces[n])
    if problem.cfg.psf == "gaussian":
        w2 = np.asarray(psf_traces["w2"])
        w2_lag = np.concatenate([[w2[0]], w2[:-1]])
        args["w2"] = jnp.asarray(w2_lag)
    kernels = jax.vmap(lambda p: model.kernel(p))(args)
    diffs = kernels - problem.kernel_true[None]
    svals = jnp.linalg.svd(diffs, compute_uv=False)
    return np.asarray(svals[:, 0] ** 2)

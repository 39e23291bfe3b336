"""Sharded SAPG: the FULL production estimator under shard_map.

Layout (SURVEY.md §2.3 — all new design; the reference has no
parallelism of any kind):

  X / Xhat / prox : (D, C, M, N)   sharded P('data', 'chains')  — D problems,
                                   C total chains per problem
  keys            : (D, C)         one PRNG key PER CHAIN (not per shard!) so
                                   the noise stream — and hence the whole
                                   trajectory — is invariant to the layout
  theta/sigma²/psf: (D,)           sharded P('data'), replicated on 'chains'
  consts (yhat …) : (D, …)         sharded P('data')

Per SAPG iteration the ONLY cross-device traffic is the lax.pmean of the
per-chain scalar statistics over the 'chains' axis — O(#hyperparams)
scalars — so scaling efficiency is expected near-perfect on ICI.

The hyperparameter update is computed identically on every chains-shard
from the pmean'd statistics (replicated state, deterministic update), so
trajectories are invariant to the chains-axis layout — asserted by
tests/test_parallel.py on an 8-device virtual CPU mesh.

`run_sapg_sharded` is the complete reference pipeline on a mesh
(SAPG_algorithm_Guassian.m:67-306): warm-up scan, main SAPG scan with the
full trace bundle, per-problem EB extraction, mid-run checkpoint/resume and
fail-fast NaN supervision (shared driver `sapg.estimator.run_segmented_scan`),
returning one full `SAPGResult` per problem — equal to
`run_sapg(n_chains=C)` single-device up to cross-chain reduction order
(tested at 1e-12 relative in f64 on the virtual mesh).
`run_sapg_sharded_steps` is the bare-stepper variant kept for throughput
benchmarks and the multi-host smoke test.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from semiblind_tv.parallel.mesh import CHAINS_AXIS, DATA_AXIS
from semiblind_tv.runtime.checkpoint import (
    load_checkpoint_arrays,
    save_checkpoint_arrays,
)
from semiblind_tv.runtime.problem import Problem
from semiblind_tv.sapg.estimator import (
    SAPGResult,
    assemble_result,
    make_general_sapg_step,
    problem_consts,
    run_segmented_scan,
)

__all__ = [
    "stack_problem_consts",
    "build_sharded_sapg",
    "run_sapg_sharded",
    "run_sapg_sharded_steps",
]


def _to_global(v, sharding: NamedSharding):
    """Place a host-replicated value onto a (possibly multi-host) sharding.

    Single-process: plain device_put.  Under jax.distributed no process can
    address the whole mesh, so each process contributes its addressable
    shards via make_array_from_callback slicing the (identical) full host
    value; typed PRNG keys round-trip through key_data."""
    if jax.process_count() == 1:
        return jax.device_put(v, sharding)
    if jnp.issubdtype(v.dtype, jax.dtypes.prng_key):
        raw = np.asarray(jax.random.key_data(v))
        glob = jax.make_array_from_callback(raw.shape, sharding, lambda idx: raw[idx])
        return jax.random.wrap_key_data(glob)
    host = np.asarray(v)
    return jax.make_array_from_callback(host.shape, sharding, lambda idx: host[idx])


def stack_problem_consts(problems: Sequence[Problem]):
    """Stack per-problem constants along a leading data axis.

    The complex yhat is split into (yhat_re, yhat_im) real planes; the
    shard_map programs reassemble it under trace with lax.complex
    (`_join_complex`).
    """
    consts = [problem_consts(p) for p in problems]

    def _stack(*xs):
        if isinstance(xs[0], np.ndarray):
            return np.stack(xs)
        return jnp.stack(xs)

    stacked = jax.tree_util.tree_map(_stack, *consts)
    yhat = stacked.pop("yhat")
    stacked["yhat_re"] = np.ascontiguousarray(yhat.real)
    stacked["yhat_im"] = np.ascontiguousarray(yhat.imag)
    return stacked


def _join_complex(c):
    """Per-problem consts dict with yhat reassembled (traced lax.complex)."""
    c = dict(c)
    c["yhat"] = jax.lax.complex(c.pop("yhat_re"), c.pop("yhat_im"))
    return c


def build_sharded_sapg(
    problems: Sequence[Problem],
    mesh: Mesh,
    chains_per_shard: int = 1,
    warmup: Optional[int] = None,
):
    """Build the sharded SAPG programs: init, warm-up scan, main-scan segment.

    All problems must share image shape, PSF family, and config (they are
    independent data-parallel instances — the driver's `for i_im` loop,
    run_Gaussian_demo.m:100).  `warmup` overrides cfg.sapg.warmup (the
    bare-stepper path passes 1 = no warm-up iterations).

    Returns a dict:
      make_init(key, x0=None) -> init dict (placed on the mesh)
      warm(init)              -> (state, logpi_wu (n_warm, D), logpi0 (D,))
      main_scan(state, iis)   -> (state, traces dict of (T, D))
      specs                   -> PartitionSpec pytrees {init, state}
      consts / aux / mesh / n_chains / n_warm
    """
    p0 = problems[0]
    cfg = p0.cfg
    model, blur = p0.model, p0.blur
    dtype = blur.dtype
    D = len(problems)
    S = mesh.shape[CHAINS_AXIS]
    Dm = mesh.shape[DATA_AXIS]
    if D % Dm != 0:
        raise ValueError(f"{D} problems not divisible over data axis {Dm}")
    C = chains_per_shard * S  # total chains per problem
    n_warm = max((cfg.sapg.warmup if warmup is None else warmup) - 1, 0)
    track_moments = cfg.sapg.track_posterior_moments

    sigma_spec = p0.sigma_spec()
    gstep, aux = make_general_sapg_step(
        model, blur, cfg,
        sigma_fix=sigma_spec.fix,
        sigma_fix_value=sigma_spec.true_value,
        axis_name=CHAINS_AXIS,
    )
    warm_step = aux["warm_step"]
    prox_b, tv_b, pnorm2 = aux["prox_b"], aux["tv_b"], aux["pnorm2"]
    theta0_c, H0 = aux["theta0"], aux["H0"]
    psf_names = aux["psf_names"]

    consts = stack_problem_consts(problems)
    theta0 = jnp.full((D,), cfg.theta.init, dtype)
    sigma0 = jnp.stack([p.sigma2_init for p in problems]).astype(dtype)
    params0 = {k: jnp.full((D,), v, dtype) for k, v in cfg.init_psf_params().items()}

    # ---- partition specs --------------------------------------------------
    sp_dc = P(DATA_AXIS, CHAINS_AXIS)
    sp_d = P(DATA_AXIS)
    extra_spec = (
        dict(pm_mean=sp_dc, pm_m2=sp_dc, pm_count=sp_d) if track_moments else {}
    )
    init_spec = dict(X=sp_dc, keys=sp_dc, theta=sp_d, sigma2=sp_d, params=sp_d)
    state_spec = dict(
        X=sp_dc, Xhat=sp_dc, prox=sp_dc, keys=sp_dc,
        theta=sp_d, sigma2=sp_d, params=sp_d, extra=extra_spec,
    )

    def make_init(key, x0=None):
        """Initial sharded arrays.  x0 defaults to each problem's y
        (op.X0 default — SAPG_algorithm_Guassian.m:10-12); one PRNG key per
        chain.  `key` may be a single key (split (D, C) — the D=1 stream
        then equals run_sapg's split(key, C) exactly) or an array of D
        per-problem keys (each problem's chain stream then equals a
        single-device run_sapg(problem, key[d], n_chains=C))."""
        if x0 is None:
            X0 = jnp.stack([jnp.broadcast_to(p.y, (C,) + tuple(blur.shape)) for p in problems])
        else:
            x0 = jnp.asarray(x0, dtype)
            X0 = jnp.broadcast_to(x0, (D, C) + tuple(blur.shape))
        if key.ndim == 1 and key.shape[0] == D:
            keys = jax.vmap(lambda k: jax.random.split(k, C))(key)
        else:
            keys = jax.random.split(key, (D, C))
        init = dict(
            X=X0.astype(dtype), keys=keys, theta=theta0, sigma2=sigma0, params=params0
        )
        return jax.tree_util.tree_map(
            lambda v, sp: _to_global(v, NamedSharding(mesh, sp)),
            init,
            dict(init_spec, params={k: sp_d for k in params0}),
            is_leaf=lambda v: isinstance(v, (jnp.ndarray, np.ndarray)),
        )

    # ---- warm-up program (SAPG_algorithm_Guassian.m:67-93) ----------------
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(init_spec, sp_d),
        out_specs=(state_spec, P(None, DATA_AXIS), sp_d),
        check_vma=False,
    )
    def warm_program(init, consts_l):
        def one_init(X, c):
            c = _join_complex(c)
            prox0, _ = prox_b(X, c["lam"] * theta0_c)
            return blur.rfft(X), prox0

        Xhat0, prox0 = jax.vmap(one_init)(init["X"], consts_l)
        carry0 = (init["X"], Xhat0, prox0, init["keys"])

        def body(carry, _):
            def one(X, Xhat, prox, keys, c):
                return warm_step((X, Xhat, prox, keys), None, _join_complex(c))

            return jax.vmap(one)(*carry, consts_l)

        if n_warm > 0:
            carry, logpi_wu = jax.lax.scan(body, carry0, None, length=n_warm)
        else:
            carry = carry0
            logpi_wu = jnp.zeros((0, init["X"].shape[0]), dtype)

        X, Xhat, prox, keys = carry

        # logPiTraceX(1): logPi at the warm-start sample with the init params
        def one_lp0(Xd, Xhatd, c):
            c = _join_complex(c)
            res2 = pnorm2(H0[None] * Xhatd - c["yhat"][None])
            lp = jnp.mean(-res2 / (2.0 * c["sigma2_init"]) - theta0_c * tv_b(Xd))
            return jax.lax.pmean(lp, CHAINS_AXIS)

        logpi0 = jax.vmap(one_lp0)(X, Xhat, consts_l)

        if track_moments:
            extra = dict(
                pm_mean=jnp.zeros_like(X),
                pm_m2=jnp.zeros_like(X),
                pm_count=jnp.zeros((X.shape[0],), dtype),
            )
        else:
            extra = {}
        state = dict(
            X=X, Xhat=Xhat, prox=prox, keys=keys,
            theta=init["theta"], sigma2=init["sigma2"], params=init["params"],
            extra=extra,
        )
        return state, logpi_wu, logpi0

    # ---- main-scan segment (SAPG_algorithm_Guassian.m:158-247) ------------
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, sp_d, P()),
        out_specs=(state_spec, P(None, DATA_AXIS)),
        check_vma=False,
    )
    def main_scan(state, consts_l, iis):
        def body(st, ii):
            def one(X, Xhat, prox, keys, theta, sigma2, params, extra, c):
                carry = (X, Xhat, prox, keys, theta, sigma2, params, extra)
                (Xn, Xhn, pn, kn, tn, sn, prn, exn), trace = gstep(
                    carry, ii, _join_complex(c)
                )
                return (
                    dict(X=Xn, Xhat=Xhn, prox=pn, keys=kn, theta=tn,
                         sigma2=sn, params=prn, extra=exn),
                    trace,
                )

            return jax.vmap(one)(
                st["X"], st["Xhat"], st["prox"], st["keys"],
                st["theta"], st["sigma2"], st["params"], st["extra"], consts_l,
            )

        return jax.lax.scan(body, state, iis)

    warm_jit = jax.jit(lambda init: warm_program(init, consts))
    main_jit = jax.jit(lambda state, iis: main_scan(state, consts, iis))

    return dict(
        make_init=make_init,
        warm=warm_jit,
        main_scan=main_jit,
        specs=dict(init=init_spec, state=state_spec),
        consts=consts,
        aux=aux,
        mesh=mesh,
        n_chains=C,
        n_warm=n_warm,
        psf_names=psf_names,
        blur=blur,
        dtype=dtype,
    )


def _save_state(path, state, done_iters, seg_traces, logpi_wu, logpi0,
                backend="npz"):
    """Persist the sharded state dict + completed iterations + traces.

    Xhat (complex, recomputable) is dropped; PRNG keys stored via key_data.
    The warm-up trace rides along so a resumed run skips the warm-up phase.
    Host gather via np.asarray — single-controller (the multi-host path
    should use backend='orbax' with every process calling save)."""
    merged = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *seg_traces)
    arrays = {f"trace/{k}": v for k, v in merged.items()}
    arrays.update(
        X=np.asarray(state["X"]),
        prox=np.asarray(state["prox"]),
        keys=np.asarray(jax.random.key_data(state["keys"])),
        theta=np.asarray(state["theta"]),
        sigma2=np.asarray(state["sigma2"]),
        done_iters=np.asarray(done_iters),
        logpi_wu=np.asarray(logpi_wu),
        logpi0=np.asarray(logpi0),
    )
    for k, v in state["params"].items():
        arrays[f"param/{k}"] = np.asarray(v)
    for k, v in state["extra"].items():
        arrays[f"extra/{k}"] = np.asarray(v)
    save_checkpoint_arrays(path, arrays, backend=backend)


def _restore_state(path, built, backend=None):
    """Inverse of _save_state: load, re-place on the mesh, recompute Xhat
    shard-locally (bit-identical to the dropped value)."""
    mesh = built["mesh"]
    blur = built["blur"]
    state_spec = built["specs"]["state"]
    z = load_checkpoint_arrays(path, backend=backend)
    params = {k[len("param/"):]: jnp.asarray(z[k]) for k in z if k.startswith("param/")}
    extra = {k[len("extra/"):]: jnp.asarray(z[k]) for k in z if k.startswith("extra/")}
    traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
    state = dict(
        X=jnp.asarray(z["X"]),
        prox=jnp.asarray(z["prox"]),
        keys=jax.random.wrap_key_data(jnp.asarray(z["keys"])),
        theta=jnp.asarray(z["theta"]),
        sigma2=jnp.asarray(z["sigma2"]),
        params=params,
        extra=extra,
    )
    specs = {k: v for k, v in state_spec.items() if k != "Xhat"}
    specs = dict(specs, params={k: P(DATA_AXIS) for k in params})
    state = jax.tree_util.tree_map(
        lambda v, sp: _to_global(v, NamedSharding(mesh, sp)),
        state,
        specs,
        is_leaf=lambda v: isinstance(v, (jnp.ndarray, np.ndarray)),
    )
    rfft_sharded = jax.jit(
        jax.shard_map(
            blur.rfft,
            mesh=mesh,
            in_specs=P(DATA_AXIS, CHAINS_AXIS),
            out_specs=P(DATA_AXIS, CHAINS_AXIS),
            check_vma=False,
        )
    )
    state["Xhat"] = rfft_sharded(state["X"])
    return state, int(z["done_iters"]), [traces], z["logpi_wu"], z["logpi0"]


def run_sapg_sharded(
    problems: Sequence[Problem],
    mesh: Mesh,
    key,
    chains_per_shard: int = 1,
    x0=None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_backend: str = "npz",
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
) -> List[SAPGResult]:
    """The COMPLETE reference pipeline on a ('data', 'chains') mesh.

    Warm-up (SAPG_algorithm_Guassian.m:67-93) → main SAPG scan with the full
    trace bundle (:158-247) → per-problem EB extraction (:258-290), with
    mid-run checkpoint/resume and fail-fast NaN supervision (see
    run_segmented_scan).  Returns one full SAPGResult per problem —
    identical in content to run_sapg(problem, n_chains=C) up to cross-chain
    reduction order.
    """
    built = build_sharded_sapg(problems, mesh, chains_per_shard)
    samples = problems[0].cfg.sapg.samples

    t0 = time.perf_counter()
    resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
    if resume:
        # the checkpoint carries the warm-up trace — skip the warm-up phase
        state = logpi_wu = logpi0 = None
    else:
        init = built["make_init"](key, x0)
        state, logpi_wu, logpi0 = built["warm"](init)

    def _restore():
        nonlocal logpi_wu, logpi0
        st, done, traces, logpi_wu, logpi0 = _restore_state(
            checkpoint_path, built, backend=checkpoint_backend
        )
        return st, done, traces

    main = built["main_scan"]
    state, seg_traces = run_segmented_scan(
        lambda s, iis: main(s, iis),
        state,
        samples,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path,
        save_fn=lambda s, done, segs: _save_state(
            checkpoint_path, s, done, segs, logpi_wu, logpi0,
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
    jax.block_until_ready(state["X"])
    exec_time = time.perf_counter() - t0

    logpi_wu = np.asarray(logpi_wu)
    logpi0 = np.asarray(logpi0)
    X_host = np.asarray(state["X"])
    extra_host = {k: np.asarray(v) for k, v in state["extra"].items()}
    results = []
    for d, prob in enumerate(problems):
        tr_d = {k: np.asarray(v)[:, d] for k, v in traces.items()}
        extra_d = {
            k: (v[d] if v.ndim > 0 else v) for k, v in extra_host.items()
        }
        results.append(
            assemble_result(
                prob,
                built["psf_names"],
                tr_d,
                logpi_wu[:, d] if logpi_wu.size else np.zeros(0),
                float(logpi0[d]),
                X_host[d],
                extra_d,
                exec_time,
            )
        )
    return results


def run_sapg_sharded_steps(problems, mesh, key, chains_per_shard=1, n_steps=100):
    """Bare-stepper variant: n_steps sharded SAPG iterations from a warm
    start at y, NO warm-up phase.  Returns (state, theta trace (D, n_steps)).

    Kept for throughput benchmarks, the sharding-invariance quick tests and
    the multi-host smoke test; the production path is run_sapg_sharded.
    """
    built = build_sharded_sapg(problems, mesh, chains_per_shard, warmup=1)
    init = built["make_init"](key)
    state, _, _ = built["warm"](init)
    iis = jnp.arange(2, n_steps + 2)
    state, traces = built["main_scan"](state, iis)
    return state, np.asarray(traces["theta"]).T

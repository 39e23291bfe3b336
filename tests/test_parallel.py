"""Multi-chip SPMD tests on the 8-device virtual CPU mesh.

Asserts the SURVEY §4 requirement (psum-reduced SAPG trajectories invariant
to the sharding layout) and the round-2 production requirement: the FULL
sharded estimator — warm-up, traces, EB extraction, checkpoint/resume,
posterior moments — matches `run_sapg` single-device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semiblind_tv.parallel.mesh import make_mesh
from semiblind_tv.parallel.sapg_parallel import (
    run_sapg_sharded,
    run_sapg_sharded_steps,
)
from semiblind_tv.runtime import build_problem, gaussian_preset
from semiblind_tv.sapg import run_sapg
from semiblind_tv.sapg.estimator import SAPGDivergenceError
from semiblind_tv.utils import synthetic_wheel

SIZE = 32

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _short(cfg, samples=24, warmup=6, burn_in=16, **kw):
    return dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(
            cfg.sapg, samples=samples, warmup=warmup, burn_in=burn_in, **kw
        ),
    )


def _problems(n, cfg=None, dtype=jnp.float64):
    cfg = cfg or gaussian_preset(fix_w1=False, fix_w2=False)
    img = synthetic_wheel(SIZE)
    keys = jax.random.split(jax.random.key(0), n)
    return [build_problem(img, cfg, keys[i], dtype=dtype) for i in range(n)]


@needs8
def test_chains_sharding_invariance():
    """Same 8 total chains on (1,8) / (1,4)x2 / (1,1)x8 layouts -> same
    hyperparameter trajectory (per-chain RNG keys, psum'd stats)."""
    probs = _problems(1)
    key = jax.random.key(42)
    traces = []
    for devs, per_shard in [(8, 1), (4, 2), (1, 8)]:
        mesh = make_mesh(data=1, chains=devs, devices=jax.devices()[:devs])
        _, thetas = run_sapg_sharded_steps(
            probs, mesh, key, chains_per_shard=per_shard, n_steps=8
        )
        traces.append(thetas)
    np.testing.assert_allclose(traces[0], traces[1], rtol=1e-9)
    np.testing.assert_allclose(traces[0], traces[2], rtol=1e-9)


@needs8
def test_full_sharded_estimator_matches_single_device():
    """THE production requirement: the complete
    sharded pipeline — warm-up, main scan, EB extraction, posterior
    moments — equals run_sapg(n_chains=8) single-device up to cross-chain
    reduction order (f64, tight tolerance)."""
    cfg = _short(
        gaussian_preset(fix_w1=False, fix_w2=False),
        track_posterior_moments=True,
    )
    [prob] = _problems(1, cfg=cfg)
    key = jax.random.key(5)

    ref = run_sapg(prob, key, n_chains=8)

    mesh = make_mesh(data=1, chains=8)
    res = run_sapg(prob, key, n_chains=8, mesh=mesh)

    np.testing.assert_allclose(res.thetas, ref.thetas, rtol=1e-12)
    np.testing.assert_allclose(res.sigma2s, ref.sigma2s, rtol=1e-12)
    for n in ref.psf_param_traces:
        np.testing.assert_allclose(
            res.psf_param_traces[n], ref.psf_param_traces[n], rtol=1e-12
        )
    np.testing.assert_allclose(res.logPiTrace, ref.logPiTrace, rtol=1e-10)
    np.testing.assert_allclose(
        res.logPiTrace_warmup, ref.logPiTrace_warmup, rtol=1e-10
    )
    np.testing.assert_allclose(res.gX, ref.gX, rtol=1e-10)
    assert res.theta_EB == pytest.approx(ref.theta_EB, rel=1e-12)
    assert res.sigma2_EB == pytest.approx(ref.sigma2_EB, rel=1e-12)
    for n, v in ref.psf_params_EB.items():
        assert res.psf_params_EB[n] == pytest.approx(v, rel=1e-12)
    # per-chain states and Welford posterior moments (chain order preserved)
    np.testing.assert_allclose(res.X_last, ref.X_last, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        res.posterior_mean, ref.posterior_mean, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        res.posterior_var, ref.posterior_var, rtol=1e-8, atol=1e-14
    )


@needs8
def test_full_sharded_checkpoint_resume(tmp_path):
    """Kill/resume on the mesh: a checkpointed sharded run interrupted
    mid-way and resumed equals the uninterrupted sharded run exactly."""
    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    probs = _problems(1, cfg=cfg)
    key = jax.random.key(9)
    mesh = make_mesh(data=1, chains=8)

    [full] = run_sapg_sharded(probs, mesh, key, chains_per_shard=1)

    ckpt = str(tmp_path / "sharded.npz")
    # simulate preemption: run only the first 2 segments (samples=24 ->
    # main iterations 2..24; stop after iteration 15 by truncating samples)
    cfg_half = dataclasses.replace(
        probs[0].cfg,
        sapg=dataclasses.replace(probs[0].cfg.sapg, samples=15, burn_in=10),
    )
    probs_half = [dataclasses.replace(probs[0], cfg=cfg_half)]
    run_sapg_sharded(
        probs_half, mesh, key, chains_per_shard=1,
        checkpoint_every=7, checkpoint_path=ckpt,
    )
    # resume with the full budget from the mid-run checkpoint
    [resumed] = run_sapg_sharded(
        probs, mesh, key, chains_per_shard=1,
        checkpoint_every=7, checkpoint_path=ckpt,
    )
    np.testing.assert_allclose(resumed.thetas, full.thetas, rtol=1e-12)
    np.testing.assert_allclose(resumed.sigma2s, full.sigma2s, rtol=1e-12)
    np.testing.assert_allclose(resumed.logPiTrace, full.logPiTrace, rtol=1e-12)
    assert resumed.theta_EB == pytest.approx(full.theta_EB, rel=1e-12)


@needs8
def test_data_axis_full_results():
    """2 independent problems on a (2,4) mesh: full per-problem SAPGResults,
    each equal to its own single-device run_sapg (per-problem keys make the
    chain streams identical)."""
    probs = _problems(2, cfg=_short(gaussian_preset(fix_w1=False, fix_w2=False)))
    mesh = make_mesh(data=2, chains=4)
    prob_keys = jax.random.split(jax.random.key(7), 2)
    res = run_sapg_sharded(probs, mesh, prob_keys, chains_per_shard=1)
    assert len(res) == 2
    # different noise realisations -> different trajectories
    assert not np.allclose(res[0].thetas, res[1].thetas)
    assert res[0].X_last.shape == (4, SIZE, SIZE)
    for d, prob in enumerate(probs):
        ref = run_sapg(prob, prob_keys[d], n_chains=4)
        np.testing.assert_allclose(res[d].thetas, ref.thetas, rtol=1e-12)
        np.testing.assert_allclose(res[d].sigma2s, ref.sigma2s, rtol=1e-12)
        assert res[d].theta_EB == pytest.approx(ref.theta_EB, rel=1e-12)


@needs8
def test_nan_guard_auto_restore(tmp_path):
    """Failure supervision (SURVEY §5): a transient fault that corrupts the
    carry mid-run is detected (non-finite traces) and the run auto-restores
    from the last checkpoint and completes, matching the clean run."""
    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    probs = _problems(1, cfg=cfg)
    key = jax.random.key(11)
    mesh = make_mesh(data=1, chains=8)

    [clean] = run_sapg_sharded(probs, mesh, key, chains_per_shard=1)

    fired = []

    def corrupt_once(seg_idx, state):
        # inject a hardware-fault NaN into the chain state before segment 2
        if seg_idx == 2 and not fired:
            fired.append(seg_idx)
            state = dict(state, X=state["X"].at[0, 0, 0, 0].set(jnp.nan))
        return state

    ckpt = str(tmp_path / "guard.npz")
    [recovered] = run_sapg_sharded(
        probs, mesh, key, chains_per_shard=1,
        checkpoint_every=7, checkpoint_path=ckpt,
        fault_hook=corrupt_once,
    )
    assert fired == [2]
    np.testing.assert_allclose(recovered.thetas, clean.thetas, rtol=1e-12)
    assert np.all(np.isfinite(recovered.logPiTrace))


@needs8
def test_nan_guard_raises_without_checkpoint():
    """Without a checkpoint to restore from, divergence fails fast instead
    of burning the remaining budget."""
    cfg = _short(gaussian_preset(fix_w1=False, fix_w2=False))
    probs = _problems(1, cfg=cfg)
    mesh = make_mesh(data=1, chains=8)

    def corrupt(seg_idx, state):
        return dict(state, X=jnp.full_like(state["X"], jnp.nan))

    with pytest.raises(SAPGDivergenceError):
        run_sapg_sharded(
            probs, mesh, jax.random.key(1), chains_per_shard=1,
            checkpoint_every=7, checkpoint_path=None, fault_hook=corrupt,
        )


@needs8
def test_dryrun_multichip_entrypoint():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__

    fn, (carry, ii) = __graft_entry__.entry()
    out_carry, trace = jax.jit(fn)(carry, ii)
    jax.block_until_ready(trace["theta"])
    assert np.isfinite(float(trace["theta"]))


def test_dryrun_multichip_raises_when_devices_short():
    """No fallback to a virtual mesh: too few devices is an error."""
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        __graft_entry__.dryrun_multichip(16)


def test_spatial_mesh_raises_when_devices_short():
    from semiblind_tv.parallel.mesh import make_spatial_mesh

    assert make_spatial_mesh(4).devices.size == 4
    with pytest.raises(ValueError):
        make_spatial_mesh(len(jax.devices()) + 1)

"""Worker for the 2-process jax.distributed smoke test.

Each process contributes 2 virtual CPU devices to a 4-device global mesh
and runs a short sharded SAPG; process 0 prints the final theta values.
Launched by tests/test_multihost.py.  CPU only: every result line ends
with the platform, "cpu"; nothing here is a device measurement.
"""
import sys

import jax

PORT = sys.argv[1]
PID = int(sys.argv[2])

jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"localhost:{PORT}", num_processes=2, process_id=PID
)

import numpy as np  # noqa: E402

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

from semiblind_tv.parallel.mesh import make_mesh  # noqa: E402
from semiblind_tv.parallel.sapg_parallel import run_sapg_sharded_steps  # noqa: E402
from semiblind_tv.runtime import build_problem, gaussian_preset  # noqa: E402
from semiblind_tv.utils import synthetic_wheel  # noqa: E402

assert jax.process_count() == 2, jax.process_count()
# a CPU-only emulation of two hosts: every line printed names the platform
PLATFORM = jax.default_backend()
assert PLATFORM == "cpu", PLATFORM
assert len(jax.devices()) == 4, jax.devices()

cfg = gaussian_preset(fix_w1=False, fix_w2=False)
problem = build_problem(synthetic_wheel(32), cfg, jax.random.key(0))
mesh = make_mesh(data=1, chains=4)
state, thetas = run_sapg_sharded_steps(
    [problem], mesh, jax.random.key(1), chains_per_shard=2, n_steps=6
)
# gather the (replicated-on-chains, data-sharded) theta to every host
from jax.experimental import multihost_utils  # noqa: E402

theta_global = multihost_utils.process_allgather(state["theta"], tiled=True)
print(f"RESULT {PID} {float(np.ravel(theta_global)[0]):.10f} {PLATFORM}", flush=True)

# --- spatial leg: 4-device ('space',) global mesh across both processes ---
import jax.numpy as jnp  # noqa: E402

from semiblind_tv.ops.fourier import BlurOperator  # noqa: E402
from semiblind_tv.ops.psf import gaussian_kernel  # noqa: E402
from semiblind_tv.parallel.mesh import make_spatial_mesh  # noqa: E402
from semiblind_tv.parallel.spatial import spatial_salsa_tv  # noqa: E402

smesh = make_spatial_mesh(4)
blur = BlurOperator((32, 32), 7, jnp.float32, fft_mode="dft")
H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float32))
_xs, objs, n_it = spatial_salsa_tv(
    np.asarray(problem.y), H, 0.05, 0.005, smesh, max_iter=8, tv_iters=3,
    dtype=jnp.float32,
)
print(f"SPATIAL {PID} {float(objs[n_it - 1]):.10f} {PLATFORM}", flush=True)

# --- Orbax checkpoint leg: coordinated 2-process write + resume ----------
# Validates the estimator.py multi-host claim ("orbax = async multi-host-
# coordinated writes"): both processes run the same checkpointed SAPG on a
# SHARED orbax path (orbax barriers/serialises the writes under
# jax.distributed), then resume from it; segmented and resumed trajectories
# must equal the uninterrupted one exactly.
if len(sys.argv) > 3:
    import dataclasses
    import os

    from semiblind_tv.sapg import run_sapg  # noqa: E402

    ckpt = os.path.join(sys.argv[3], "orbax_ck")
    cfg_s = dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, samples=20, warmup=5, burn_in=10)
    )
    problem_s = build_problem(
        synthetic_wheel(32), cfg_s, jax.random.key(0), dtype=jnp.float64
    )
    res_full = run_sapg(problem_s, jax.random.key(3))
    res_seg = run_sapg(problem_s, jax.random.key(3), checkpoint_every=7,
                       checkpoint_path=ckpt, checkpoint_backend="orbax")
    ok_seg = bool(np.allclose(res_seg.thetas, res_full.thetas, rtol=1e-12))
    # checkpoint is present on disk → this run takes the restore path
    res_resume = run_sapg(problem_s, jax.random.key(3), checkpoint_every=7,
                          checkpoint_path=ckpt, checkpoint_backend="orbax")
    ok_res = bool(np.allclose(res_resume.thetas, res_full.thetas, rtol=1e-12))
    print(f"ORBAX {PID} {int(ok_seg and ok_res)} "
          f"{float(res_seg.thetas[-1]):.10f} {PLATFORM}", flush=True)

"""Multi-process emulation of the sharded SAPG stepper on the CPU backend.

For each process count P it spawns P OS processes, each owning one virtual
CPU device; the P processes form a global ('data','chains') mesh via
jax.distributed and run the SAME sharded SAPG stepper a multi-host job runs
(parallel.sapg_parallel.run_sapg_sharded_steps — per-step cross-host
traffic is ONE lax.pmean of O(#hyperparams) scalars).  Weak scaling:
chains-per-process is fixed, so

    efficiency(P) = rate(P) / (P · rate(1))

  python benchmarks/bench_multihost.py                 # P = 1,2,4,8
  BENCH_MH_PROCS=1,2 BENCH_MH_STEPS=100 python benchmarks/bench_multihost.py

CPU only, by design: it never opens an accelerator (one process per card
is the rule there), and every row it prints carries "platform": "cpu".
These are CPU timings of the multi-process control flow, not device
numbers; with fewer physical cores than processes they oversubscribe.
"""
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SIZE = int(os.environ.get("BENCH_MH_SIZE", "64"))
STEPS = int(os.environ.get("BENCH_MH_STEPS", "200"))
CHAINS_PER_PROC = int(os.environ.get("BENCH_MH_CHAINS", "2"))
PROCS = [int(p) for p in os.environ.get("BENCH_MH_PROCS", "1,2,4,8").split(",")]


def _worker(port: str, nprocs: int, pid: int) -> None:
    import jax

    jax.config.update("jax_num_cpu_devices", 1)
    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nprocs,
            process_id=pid,
        )
    from semiblind_tv.parallel.mesh import make_mesh
    from semiblind_tv.parallel.sapg_parallel import run_sapg_sharded_steps
    from semiblind_tv.runtime import build_problem, gaussian_preset
    from semiblind_tv.utils import synthetic_wheel

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    problem = build_problem(synthetic_wheel(SIZE), cfg, jax.random.key(0))
    mesh = make_mesh(data=1, chains=nprocs)

    # compile + warm once, then time a fresh stepper run of STEPS iterations
    run_sapg_sharded_steps(
        [problem], mesh, jax.random.key(1),
        chains_per_shard=CHAINS_PER_PROC, n_steps=5,
    )
    t0 = time.perf_counter()
    state, _ = run_sapg_sharded_steps(
        [problem], mesh, jax.random.key(2),
        chains_per_shard=CHAINS_PER_PROC, n_steps=STEPS,
    )
    jax.block_until_ready(state["theta"])
    dt = time.perf_counter() - t0
    if pid == 0:
        total = nprocs * CHAINS_PER_PROC * STEPS
        row = dict(platform=jax.default_backend(), procs=nprocs, wall_s=dt,
                   chain_iters_per_sec=total / dt)
        print(f"WORKER_RESULT {json.dumps(row)}", flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main():
    rows = []
    base = None
    for P in PROCS:
        port = _free_port()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(port), str(P), str(pid)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, text=True,
            )
            for pid in range(P)
        ]
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise SystemExit(f"worker {i}/{P} failed:\n{out[-3000:]}")
        row = None
        for line in outs[0].splitlines():
            if line.startswith("WORKER_RESULT "):
                row = json.loads(line[len("WORKER_RESULT "):])
        assert row is not None, outs[0][-2000:]
        if base is None:
            base = row["chain_iters_per_sec"]
        row["efficiency"] = round(
            row["chain_iters_per_sec"] / (base * row["procs"] / PROCS[0]), 3
        )
        row["chain_iters_per_sec"] = round(row["chain_iters_per_sec"], 1)
        row["wall_s"] = round(row["wall_s"], 2)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()

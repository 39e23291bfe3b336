"""2-process jax.distributed smoke test on CPU.

Validates the actual multi-host path (SURVEY §2.3 / north star): two OS
processes, each owning 2 virtual CPU devices, form a 4-device global mesh
and run the sharded SAPG; both must succeed and agree on the trajectory.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_sapg(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=360)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                _, pid, theta, platform = line.split()
                assert platform == "cpu", line
                results[int(pid)] = float(theta)
    assert set(results) == {0, 1}, outs
    # both processes computed the same global trajectory
    assert results[0] == results[1]
    assert 1e-3 <= results[0] <= 1.0
    # spatial leg: the halo/reduce-scatter SALSA over the cross-process
    # ('space',) mesh agrees bitwise between the two hosts
    spatial = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SPATIAL "):
                _, pid, obj, platform = line.split()
                assert platform == "cpu", line
                spatial[int(pid)] = float(obj)
    assert set(spatial) == {0, 1}, outs
    assert spatial[0] == spatial[1]
    assert np.isfinite(spatial[0])
    # orbax leg: 2-process coordinated checkpoint write + resume, both
    # trajectories ≡ the uninterrupted run and identical across hosts
    orbax = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("ORBAX "):
                _, pid, ok, theta, platform = line.split()
                assert platform == "cpu", line
                orbax[int(pid)] = (int(ok), float(theta))
    assert set(orbax) == {0, 1}, outs
    assert orbax[0][0] == 1 and orbax[1][0] == 1, outs
    assert orbax[0][1] == orbax[1][1]

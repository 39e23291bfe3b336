"""chip_smoke.py and bench.py off the card: both refuse to run without a
GPU, and the smoke's comparison helpers pass at small shapes on the CPU."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_on_cpu(script):
    out = _run(script, REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("check", ["prox", "salsa", "sapg"])
def test_comparison_helpers_pass_on_cpu(check):
    cpu = jax.devices("cpu")[0]
    if check == "prox":
        errs = chip_smoke.check_prox(64, cpu)
    elif check == "salsa":
        errs = chip_smoke.check_salsa(64, cpu, iters=20)
    else:
        errs = chip_smoke.check_sapg(64, 3, cpu, cpu)
        assert all(v == 0.0 for k, v in errs.items() if k.endswith("_vs_cpu"))
    assert errs and all(v >= 0.0 for v in errs.values())


@pytest.mark.parametrize("mesh", ["chains", "space"])
def test_four_device_helpers_on_virtual_cpus(mesh):
    """The --four phases on 4 of the 8 virtual CPU devices."""
    devices = jax.devices()[:4]
    if mesh == "chains":
        errs = chip_smoke.check_chain_mesh(devices, 32, n_chains=8, samples=12, warmup=4)
    else:
        errs = chip_smoke.check_space_mesh(devices, 32, samples=8, warmup=4)
    assert set(errs) >= {"theta", "sigma2", "w1", "w2"}

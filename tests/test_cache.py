"""Compile-cache policy: JAX_COMPILATION_CACHE_DIR when set, else the fixed
<checkout>/.jax_cache."""
import os
import subprocess
import sys

import jax

from semiblind_tv.runtime import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_lands_in_env_dir(tmp_path):
    code = (
        "import jax\n"
        "from semiblind_tv.runtime.cache import enable_persistent_cache\n"
        "print(enable_persistent_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 2 + 1)(1.0).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    assert os.listdir(tmp_path), "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_cache_defaults_to_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    path = cache.enable_persistent_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path

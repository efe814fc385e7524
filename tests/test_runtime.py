"""Process set-up (shazam_tpu/runtime.py): the compile-cache location and
the refusal of non-GPU devices by the measurement entry points."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, os, jax, jax.numpy as jnp
from shazam_tpu.runtime import enable_compile_cache
before = jax.config.jax_compilation_cache_dir
used = enable_compile_cache()
after = jax.config.jax_compilation_cache_dir
if os.environ.get("COMPILE_ONE"):
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(17.0)).block_until_ready()
print(json.dumps({"before": before, "used": used, "after": after}))
"""


def _probe(tmp_path, env_dir=None, compile_one=False):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    if compile_one:
        env["COMPILE_ONE"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_follows_env_variable(tmp_path):
    d = str(tmp_path / "cache_from_env")
    got = _probe(tmp_path, env_dir=d)
    assert got["used"] == d
    # JAX read the variable itself; the helper set no other directory
    assert got["before"] == got["after"] == d


def test_compile_cache_defaults_to_checkout(tmp_path):
    got = _probe(tmp_path)
    want = os.path.join(REPO, ".jax_cache")
    assert got["used"] == want
    assert got["after"] == want
    assert got["before"] in (None, "")


def test_compile_cache_written_only_to_env_dir(tmp_path):
    d = tmp_path / "only_here"
    got = _probe(tmp_path, env_dir=str(d), compile_one=True)
    assert got["after"] == str(d)
    assert d.is_dir() and any(d.iterdir()), "nothing was cached"
    # nothing went to the working directory's or the home's defaults
    assert not (tmp_path / ".jax_cache").exists()


def test_require_gpu_refuses_cpu():
    from shazam_tpu.runtime import require_gpu

    with pytest.raises(SystemExit) as e:
        require_gpu()
    assert "GPU" in str(e.value.code)

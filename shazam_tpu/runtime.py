"""Process set-up shared by the entry points: compile cache and device.

``enable_compile_cache`` is the one place that chooses where JAX keeps
its persistent compile cache. ``require_gpu`` and ``card_line`` are used
by the measurement scripts (``bench.py``, ``chip_smoke.py``), which run
on an NVIDIA GPU and refuse any other device instead of falling back.
"""

from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this sets no directory. Otherwise the cache goes to
    ``<checkout>/.jax_cache`` (git-ignored), a fixed path so that later
    processes of the same checkout hit it.
    """
    import jax

    cache_dir = os.environ.get(CACHE_ENV)
    if not cache_dir:
        cache_dir = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def require_gpu():
    """``jax.devices()[0]`` if it is a GPU; exit non-zero otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"this measurement needs a GPU; JAX found {dev.platform} "
            f"({dev.device_kind}). It does not fall back to another "
            "device.")
    return dev


def card_line() -> str:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()

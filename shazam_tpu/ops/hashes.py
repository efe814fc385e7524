"""Anchor/target hash generation with a static fan-out window.

Matches reference ``generate_hashes`` (``__init__.py:179-210``): peaks in
time order, anchor i pairs with peaks i+1..i+fan_value-1, keep pairs with
``min_dt <= t2 - t1 <= max_dt``, hash "f1|f2|dt" with SHA-1 truncated to
80 bits, emit with the anchor time.

Device-first: the fan-out is a *static* set of shifted slices (j = 1..fan-1),
so the pair set is a dense (fan-1, capacity) grid evaluated entirely with
vector ops + masks — no data-dependent loops. Invalid lanes still run
through SHA-1 (lane-parallel, effectively free) and are masked out.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .sha1 import sha1_fingerprint_keys


@functools.partial(jax.jit, static_argnames=("fan_value", "min_dt", "max_dt"))
def generate_hashes(times: jnp.ndarray, freqs: jnp.ndarray, n_peaks: jnp.ndarray,
                    fan_value: int = 5, min_dt: int = 0, max_dt: int = 200):
    """Pair peaks and hash them.

    :param times/freqs: uint32 (capacity,) peak coordinates in time order
        (output of ``extract_peaks``).
    :param n_peaks: true number of valid peaks (traced scalar).
    :return: (hi, lo, ex16, t1, valid) — uint32/bool arrays of shape
        ((fan_value-1) * capacity,). `valid` marks real hashes; masked
        lanes hold arbitrary key bits.
    """
    if not 0 <= min_dt <= max_dt <= 9999:
        raise ValueError(
            f"min_dt/max_dt ({min_dt}/{max_dt}) out of range: the lane "
            "SHA-1 formats each field with at most 4 decimal digits "
            "(sha1._MAX_MSG_BYTES), so dt > 9999 would hash a truncated "
            "message and silently diverge from hashlib/the reference")
    cap = times.shape[0]
    n = jnp.minimum(n_peaks, jnp.uint32(cap))
    idx = jnp.arange(cap, dtype=jnp.uint32)

    hi_list, lo_list, ex_list, t1_list, valid_list = [], [], [], [], []
    for j in range(1, fan_value):
        # target = peak i+j via a static shifted slice (zero-pad the tail)
        t2 = jnp.concatenate([times[j:], jnp.zeros(j, jnp.uint32)])
        f2 = jnp.concatenate([freqs[j:], jnp.zeros(j, jnp.uint32)])
        pair_ok = (idx + jnp.uint32(j)) < n
        dt = jnp.where(pair_ok, t2 - times, 0)
        dt_ok = (dt >= jnp.uint32(min_dt)) & (dt <= jnp.uint32(max_dt))
        valid = pair_ok & dt_ok
        hi, lo, ex = sha1_fingerprint_keys(freqs, f2, dt)
        hi_list.append(hi)
        lo_list.append(lo)
        ex_list.append(ex)
        t1_list.append(times)
        valid_list.append(valid)

    return (
        jnp.concatenate(hi_list),
        jnp.concatenate(lo_list),
        jnp.concatenate(ex_list),
        jnp.concatenate(t1_list),
        jnp.concatenate(valid_list),
    )

"""Device merge vs host merge at production index scale.

The reference's ingest cost model is a SQL INSERT per row; ours is a
sorted-run merge per chunk. Host ``merge_into`` copies the whole base
per merge (memcpy-bound); ``DeviceIndex.merge`` does the same merge in
HBM (index/devmerge.py) with only the addition crossing the wire.
This script measures wall-clock per 2M-hash addition against a 48M-row
base (the reference's production catalog held 95.5M hashes,
``fingerprints_queries.sql:2``) — 8 successive merges each, same
compiled program throughout (capacity 64M is never exceeded).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BASE_N = 48_000_000
ADD_N = 2_000_000
N_SONGS = 4096
MAX_OFF = 6000
ROUNDS = 8


def random_index(rng, n):
    from shazam_tpu.index.store import FingerprintIndex

    hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    ex = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    sid = rng.integers(0, N_SONGS, n, dtype=np.uint32)
    off = rng.integers(0, MAX_OFF, n, dtype=np.uint32)
    order = np.lexsort((off, sid, ex, lo, hi))
    return FingerprintIndex(hi[order], lo[order], ex[order], sid[order],
                            off[order], n_songs=N_SONGS,
                            max_offset=MAX_OFF)


def main():
    import jax

    from shazam_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    from shazam_tpu.index.devmerge import DeviceIndex
    from shazam_tpu.index.store import merge_into

    rng = np.random.default_rng(7)
    print(f"building {BASE_N/1e6:.0f}M-row base...", flush=True)
    base = random_index(rng, BASE_N)
    adds = [random_index(rng, ADD_N) for _ in range(ROUNDS)]

    # ---- device merges (first call compiles; timed rounds follow) ----
    dev = DeviceIndex.from_host(base)
    jax.block_until_ready(dev.cols[0])
    dev.merge(adds[0])
    jax.block_until_ready(dev.cols[0])
    t0 = time.time()
    for a in adds[1:]:
        dev.merge(a)
        jax.block_until_ready(dev.cols[0])
    dev_s = (time.time() - t0) / (ROUNDS - 1)
    print(f"device merge: {dev_s*1000:.0f} ms per {ADD_N/1e6:.0f}M-row "
          f"addition into {BASE_N/1e6:.0f}M rows "
          f"(incl. addition upload)", flush=True)

    # ---- host merges ----
    host = base
    host = merge_into(host, adds[0])  # warm allocators
    t0 = time.time()
    for a in adds[1:]:
        host = merge_into(host, a)
    host_s = (time.time() - t0) / (ROUNDS - 1)
    print(f"host merge:   {host_s*1000:.0f} ms per addition", flush=True)
    print(f"speedup: {host_s/dev_s:.1f}x; parity spot-check...", flush=True)

    # spot-check without a multi-hundred-MB download: fetch a few rows
    # by index
    import jax.numpy as jnp

    assert dev.n_valid == host.n_hashes
    idx = jnp.asarray([0, host.n_hashes // 3, host.n_hashes // 2,
                       host.n_hashes - 1])
    got_hi = np.asarray(jnp.take(dev.cols[0], idx))
    got_p = np.asarray(jnp.take(dev.cols[3], idx))
    want_p = (host.song_id.astype(np.uint64) * dev.stride
              + host.offset).astype(np.uint32)
    for i, k in enumerate(np.asarray(idx)):
        assert got_hi[i] == host.key_hi[k], (i, k)
        assert got_p[i] == want_p[k], (i, k)
    print("OK", flush=True)


if __name__ == "__main__":
    main()

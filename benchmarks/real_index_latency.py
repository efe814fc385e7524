"""recognize_clip device latency vs the REAL catalog_full index.

Loads the 31.85M-hash index dumped by ``catalog_full.py`` (CATALOG_DEBUG
run, ``catalog_debug.npz`` in the temp directory) — real fingerprints of 2,714 full-length
tracks, including the genuine hyper-common hash runs that synthetic
uniform-key benches miss — and times the single-dispatch
``recognize_on_device`` program with and without the bucket-CDF head.

Timing protocol: K iterations chained in one jitted
fori_loop consuming every output leaf; report (T_k - T_1)/(k-1).
"""

import functools
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

from shazam_tpu.api import SIA
from shazam_tpu.index.store import FingerprintIndex
from shazam_tpu.index.search import maybe_build_head
from shazam_tpu.match.ondevice import recognize_on_device

NPZ = os.environ.get("INDEX_NPZ", os.path.join(tempfile.gettempdir(),
                                                "catalog_debug.npz"))
FS = 44100
CLIP_S = 15.0


def main():
    z = np.load(NPZ)
    n_songs = int(z["song_id"].max()) + 1
    max_off = int(z["offset"].max())
    ix = FingerprintIndex(z["key_hi"], z["key_lo"], z["key_ex"],
                          z["song_id"], z["offset"], n_songs, max_off)
    print(f"index: {ix.n_hashes} hashes, {n_songs} songs, "
          f"max_off {max_off}", flush=True)
    sia = SIA(index=ix)
    dev = sia._ensure_device_index()
    head = sia._ensure_head(dev)
    jax.block_until_ready(head)
    delta_min, delta_range = sia._delta_params_for(int(CLIP_S * FS))

    # clip: regenerate a catalog song slice with catalog_full's generator
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import catalog_full as cf
    gen = cf._make_gen()
    sid = 1234
    base = sid // cf.BATCH * cf.BATCH
    sids = jnp.asarray(np.arange(base, base + cf.BATCH, dtype=np.int32))
    songs = gen(sids)
    clip = np.asarray(songs[sid - base, FS: FS + int(CLIP_S * FS)],
                      np.float32)
    cblen = -(-len(clip) // (1 << 18)) * (1 << 18)
    padded = np.zeros(cblen, np.float32)
    padded[: len(clip)] = clip

    kw = dict(
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        match_capacity=sia.config.match_capacity_fast, topn=2,
        offset_stride=sia._offset_stride, peak_capacity=8192,
        query_capacity=4096,
    )

    @functools.partial(jax.jit, static_argnames=("k", "use_head"))
    def loop(x, nv, dev_cols, hd, k, use_head=True):
        def body(i, acc):
            out = recognize_on_device(
                jnp.roll(x, i, axis=1) + acc * 1e-30, nv, dev_cols,
                head=hd if use_head else None, **kw)
            return acc + sum(jnp.sum(l.astype(jnp.float32))
                             for l in jax.tree_util.tree_leaves(out))
        return lax.fori_loop(0, k, body, jnp.float32(0))

    x = jnp.asarray(padded)[None, :]
    nv = jnp.asarray([len(clip)], np.int32)

    # sanity: the clip should recognize correctly
    out = sia.recognize_clip(clip)
    r0 = out["results"][0] if out["results"] else {}
    print(f"recognize sanity: song_id {r0.get('song_id')} (want {sid}), "
          f"votes {r0.get('hashes_matched_in_input')}", flush=True)

    for use_head in (True, False):
        res = {}
        for k in (1, 9):
            float(loop(x, nv, dev, head, k, use_head=use_head))
            best = []
            for _ in range(3):
                t0 = time.time()
                float(loop(x, nv, dev, head, k, use_head=use_head))
                best.append(time.time() - t0)
            res[k] = min(best)
        ms = (res[9] - res[1]) / 8 * 1000
        tag = "head" if use_head else "tiered"
        print(f"recognize_clip [{tag}]: {ms:.2f} ms per 15 s clip vs "
              f"{ix.n_hashes}-hash real index", flush=True)


if __name__ == "__main__":
    main()

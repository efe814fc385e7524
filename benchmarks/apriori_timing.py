"""When does the apriori early exit actually pay off?

The reference's apriori mode exits after each 1000-hash DB batch once the
leader's dedup rows double the runner-up's (recognizer_apriori.py:303) —
a win when every batch is a network round trip. The host-loop port pays
a host round trip per margin check; match_query_apriori_ondevice runs
the whole sweep as ONE device program (lax.while_loop, margin test on
device). This bench measures whether the on-device exit beats the full
match.

Three device-honest chained timings (K iterations in one jitted
fori_loop, every output leaf summed into the carry) against a 64 x 30 s catalog, for a skewed 15 s query whose exit
fires after the first batch:

  full        one-shot match_query (the production tiered path's core)
  apriori/dev the single-dispatch while_loop early exit
  apriori/rtt the host-loop variant (per-batch round trip, api wall)

Plus the api-level wall times (recognize_samples) for context.
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
from jax import lax

from shazam_tpu.api import SIA
from shazam_tpu.audio.synth import synth_song
from shazam_tpu.match.apriori import (_apriori_device_loop,
                                      match_query_apriori)
from shazam_tpu.match.lookup import match_query
from shazam_tpu.match.prepare import prepare_query

sia = SIA()
songs = [(f"t{i}", synth_song(i, duration_s=30.0, seed=5)) for i in range(64)]
sia.ingest_arrays(songs)

clip = songs[7][1][44100 : 44100 * 16]  # 15 s -> ~3K pairs, several batches

# ---- api-level wall times (includes fingerprint + host round trips) ---


def timed_api(early):
    sia.recognize_samples([clip], early_exit=early)  # warm/compile
    best = []
    for _ in range(5):
        t0 = time.time()
        out = sia.recognize_samples([clip], early_exit=early)
        best.append(time.time() - t0)
    assert out["results"][0]["song_name"] == "t7"
    return min(best), out["query_time"]


full_t, full_q = timed_api(False)
ap_t, ap_q = timed_api(True)
print(f"api full:         total {full_t*1000:.0f} ms (query {full_q*1000:.0f} ms)")
print(f"api apriori/dev:  total {ap_t*1000:.0f} ms (query {ap_q*1000:.0f} ms)")

# ---- device-honest chained timings of the match programs --------------

q = prepare_query([sia._fingerprint_channel(clip.astype(np.float32))])
dev = sia._ensure_device_index()
head = sia._ensure_head(dev)
n_songs = sia.index.n_songs
delta_min, delta_range = sia._delta_params_for(len(clip))
kw = dict(n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
          match_capacity=sia.config.match_capacity,
          offset_stride=sia._offset_stride)

raw_host, used_host, _ = match_query_apriori(dev, q, topn=2, head=head,
                                             batch_size=1024, **kw)
n = max(int(q.n_pairs), 1)
batch_size = 1024
n_batches = max(1, -(-n // batch_size))
n_cap = 1 << (n_batches - 1).bit_length()
L = n_cap * batch_size


def pad(a, fill=0):
    a = np.asarray(a[:n])
    return jnp.asarray(np.pad(a, (0, L - len(a)), constant_values=fill))


qa = (pad(q.hi), pad(q.lo), pad(q.ex), pad(q.t),
      pad(q.valid, False), pad(q.first, False))
qfull = tuple(jnp.asarray(np.asarray(a[:L]) if len(a) >= L
                          else np.pad(np.asarray(a), (0, L - len(a))))
              for a in (q.hi, q.lo, q.ex, q.t, q.valid, q.first))


# dev/head threaded as ARGUMENTS, not closed over: a closed-over index
# serializes into the HLO as a constant, a program of gigabytes at a
# realistic catalog size.
@functools.partial(jax.jit, static_argnames=("k", "mode"))
def chain(qa, dev_cols, hd, k, mode):
    def body(i, acc):
        bump = (acc * 1e-30).astype(jnp.uint32)
        args = (qa[0] ^ bump,) + qa[1:]
        if mode == "apriori":
            out = _apriori_device_loop(
                dev_cols, *args, jnp.int32(n_batches),
                batch_size=batch_size, topn=2, head=hd, **kw)
        else:
            out = match_query(dev_cols, *args, topn=2, head=hd, **kw)
        return acc + sum(jnp.sum(l.astype(jnp.float32))
                         for l in jax.tree_util.tree_leaves(out))
    return lax.fori_loop(0, k, body, jnp.float32(0))


def measure(mode, qargs):
    res = {}
    for k in (1, 9):
        float(chain(qargs, dev, head, k, mode))
        best = []
        for _ in range(3):
            t0 = time.time()
            float(chain(qargs, dev, head, k, mode))
            best.append(time.time() - t0)
        res[k] = min(best)
    return (res[9] - res[1]) / 8 * 1000


ms_full = measure("full", qfull)
ms_ap = measure("apriori", qa)
print(f"device full match:    {ms_full:.2f} ms "
      f"({n} pairs, one expansion)")
print(f"device apriori exit:  {ms_ap:.2f} ms "
      f"(exits after {used_host}/{n_batches} batches of {batch_size})")
print("verdict:", "on-device apriori pays off" if ms_ap < ms_full else
      "full match still wins (batch-1 expansion + rank dominates; "
      "apriori remains reference parity, not a fast path)")

"""Pin bench.py's real-index query headline path.

The real-index headline loads a CATALOG_SAVE snapshot
(prefix.idx.npz + prefix.queries.npz, written by
benchmarks/catalog_full.py) — this test builds a tiny snapshot in the
same format and drives `bench_query_latency_real` end to end, so the
file contract (array keys, pack shapes, tier probing, the chained
timing loop) is covered on the CPU and not just on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from shazam_tpu.api import SIA, _batch_fingerprints  # noqa: E402
from shazam_tpu.audio.synth import synth_song  # noqa: E402
from shazam_tpu.match.prepare import prepare_query  # noqa: E402
from shazam_tpu.ops.fingerprint import fingerprint_batch  # noqa: E402


def _write_snapshot(prefix, n_songs=6, dur=12.0, clip_s=5.0):
    fs = 44100
    sia = SIA()
    songs = [(f"t{i}", synth_song(i, duration_s=dur, seed=9))
             for i in range(n_songs)]
    sia.ingest_arrays(songs)
    sia._index.save(prefix + ".idx.npz")

    # real query packs through the production fingerprint path,
    # exactly as catalog_full.py saves them
    clip_samples = int(clip_s * fs)
    qn = 3
    blen = -(-clip_samples // (1 << 18)) * (1 << 18)
    cb = np.zeros((qn, blen), np.float32)
    for i in range(qn):
        start = fs * (1 + i)
        cb[i, :clip_samples] = songs[i][1][start:start + clip_samples]
    cfg = sia.config
    fp = jax.device_get(fingerprint_batch(
        jnp.asarray(cb), jnp.asarray([clip_samples] * qn, np.int32),
        fs=cfg.sample_rate, wsize=cfg.window_size, hop=cfg.hop,
        amp_min=cfg.amp_min, radius=cfg.peak_neighborhood_size,
        fan_value=cfg.fan_value, min_dt=cfg.min_hash_time_delta,
        max_dt=cfg.max_hash_time_delta, peak_capacity=cfg.peak_capacity))
    packs = [prepare_query([_batch_fingerprints(fp, i)], pad_to=1024)
             for i in range(qn)]
    np.savez(prefix + ".queries.npz",
             hi=np.stack([p.hi for p in packs]),
             lo=np.stack([p.lo for p in packs]),
             ex=np.stack([p.ex for p in packs]),
             t=np.stack([p.t for p in packs]),
             valid=np.stack([p.valid for p in packs]),
             first=np.stack([p.first for p in packs]),
             n_songs=np.int64(n_songs),
             clip_samples=np.int64(clip_samples))


def test_bench_real_index_headline(tmp_path, monkeypatch):
    prefix = str(tmp_path / "tinybuild")
    _write_snapshot(prefix)

    monkeypatch.setattr(bench, "REAL_DB_PREFIXES", [prefix])
    out = bench.bench_query_latency_real(jax, jnp, chain=3)
    assert out is not None
    per_query, max_rows, n_hashes, n_songs, cap, esc, t_fast, policy = out
    assert per_query > 0
    assert n_songs == 6
    assert n_hashes > 1000
    assert max_rows > 0
    assert cap >= 16384
    assert 0.0 <= esc <= 1.0
    assert t_fast > 0
    # a tiny build fits the fast tier: nothing escalates, the policy
    # p50 IS the fast-tier time, and the small-index regime (below
    # bounds_probe_min_rows) keeps the early-accept policy
    assert esc == 0.0 and per_query == t_fast
    assert policy["policy"].startswith("fast tier")
    assert policy["escalated_tier_ms"] == 0.0
    assert policy["fast_tier_ms"] > 0


def test_bench_real_index_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "REAL_DB_PREFIXES",
                        [str(tmp_path / "nope")])
    assert bench.bench_query_latency_real(jax, jnp) is None

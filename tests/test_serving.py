"""ShardedCatalog end-to-end: ingest on one device, serve across the mesh."""

import numpy as np
import pytest

from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_corpus, synth_song
from shazam_tpu.match.prepare import prepare_query


N_SONGS = 5
DUR = 8.0


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("scorpus")
    files = [f for f, _ in synth_corpus(str(d), N_SONGS, duration_s=DUR, seed=31)]
    sia = SIA()
    sia.ingest_files(files, batch_size=4)
    return sia


@pytest.mark.parametrize("dense_limit", [1 << 30, 1])  # key_range / by_song
def test_sharded_catalog_serves(engine, dense_limit):
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        dense_limit_bytes=dense_limit)
    expected_regime = "key_range" if dense_limit > 1 else "by_song"
    assert sc.stats()["regime"] == expected_regime

    song = synth_song(2, duration_s=DUR, seed=31)
    clip = song[int(1.5 * 44100): int(6.5 * 44100)]
    fp = engine._fingerprint_channel(clip)
    q = prepare_query([fp])
    matched = sc.match(q, topn=3)
    assert matched.results
    top = matched.results[0]
    assert top["song_name"] == "track000002"

    # agreement with the single-device engine
    single = engine.recognize_samples([clip], topn=3)
    ref = single["results"][0]
    assert top["song_id"] == ref["song_id"]
    assert top["offset"] == ref["offset"]
    assert top["hashes_matched_in_input"] == ref["hashes_matched_in_input"]
    assert matched.total_matches == single["total_matches"]


def test_sharded_recognizer_serves_http(engine):
    """ShardedRecognizer is a drop-in serve engine: clips posted over
    HTTP match across the mesh with SIA-identical results."""
    import json
    import urllib.request

    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.serve import RecognitionServer
    from tests.test_serve import _wav_bytes

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        config=engine.config)
    rec = ShardedRecognizer(sc)
    song = synth_song(2, duration_s=DUR, seed=31)
    clip = song[int(1.5 * 44100): int(6.5 * 44100)]

    direct = rec.recognize_samples([clip], topn=3)
    single = engine.recognize_samples([clip], topn=3)
    assert (direct["results"][0]["song_name"]
            == single["results"][0]["song_name"])
    assert direct["total_matches"] == single["total_matches"]

    srv = RecognitionServer(rec, port=0, max_batch=4, max_wait_ms=50.0,
                            request_timeout_s=600.0)
    srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/recognize?topn=3",
            data=_wav_bytes(clip), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        assert (out["results"][0]["song_name"]
                == single["results"][0]["song_name"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["index_hashes"] == engine.index.n_hashes
    finally:
        srv.close()


def test_match_program_cached_across_queries(engine):
    """Repeated match() calls must reuse one jitted program — the old
    per-call shard_map closure retraced (and recompiled) EVERY query,
    making multi-chip serving unusable."""
    from shazam_tpu.parallel import bigcatalog, sharded
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog

    mesh = make_mesh(8)
    song = synth_song(1, duration_s=DUR, seed=31)
    clips = [song[int(s * 44100): int((s + 4) * 44100)] for s in (1.0, 2.0)]
    for dense_limit, mod, cache in (
            (1 << 30, sharded, sharded._match_query_program),
            (1, bigcatalog, bigcatalog._match_by_song_program)):
        sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                            dense_limit_bytes=dense_limit)
        cache.cache_clear()
        for clip in clips:
            q = prepare_query([engine._fingerprint_channel(clip)])
            out = sc.match(q)
            assert out.results
        info = cache.cache_info()
        assert info.misses == 1 and info.hits >= 1, info


def test_sharded_match_capacity_escalation(engine):
    """A hyper-hot hash whose rows exceed the per-shard expansion cap
    must escalate (every row votes — reference parity), not return
    truncated counts."""
    from shazam_tpu.index.store import FingerprintIndex
    from shazam_tpu.match.lookup import match_query
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog

    rng = np.random.default_rng(3)
    n, hot = 60_000, 20_000  # hot rows > per-shard cap 65536/8 = 8192
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    ex = rng.integers(0, 2**16, n, dtype=np.uint32)
    sid = rng.integers(0, 50, n, dtype=np.uint32)
    off = rng.integers(0, 2000, n, dtype=np.uint32)
    hi[:hot] = 0x7777; lo[:hot] = 0x8888; ex[:hot] = 0x99
    sid[:hot] = 7; off[:hot] = 300  # every hot row votes (song 7, one delta)
    order = np.lexsort((ex, lo, hi))
    index = FingerprintIndex(hi[order], lo[order], ex[order], sid[order],
                             off[order], n_songs=50, max_offset=2000)

    q_pairs = 1024
    q_hi = rng.integers(0, 2**32, q_pairs, dtype=np.uint32)
    q_lo = rng.integers(0, 2**32, q_pairs, dtype=np.uint32)
    q_ex = rng.integers(0, 2**16, q_pairs, dtype=np.uint32)
    q_hi[0], q_lo[0], q_ex[0] = 0x7777, 0x8888, 0x99
    q_t = np.full(q_pairs, 100, np.uint32)
    from shazam_tpu.match.prepare import QueryPairs
    q = QueryPairs(q_hi, q_lo, q_ex, q_t, np.ones(q_pairs, bool),
                   np.ones(q_pairs, bool), q_pairs)

    mesh = make_mesh(8)
    sc = ShardedCatalog(index, mesh=mesh, dense_limit_bytes=1 << 30)
    out = sc.match(q, topn=2)
    assert not out.overflowed
    top = out.results[0]
    assert top["song_id"] == 7
    # every hot row voted: (song 7, delta 300-100) holds all 20K votes
    assert top["hashes_matched_in_input"] >= hot


def test_sharded_recognizer_warmup(engine):
    """serve.warmup() drives the full engine surface incl. q_pad_to —
    the duck type RecognitionServer consumes (regression: TypeError on
    the CLI serve path before the listener ever opened)."""
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.serve import warmup

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        config=engine.config)
    rec = ShardedRecognizer(sc)
    warmup(rec, seconds=2.0, max_batch=2)


def test_sharded_recognizer_streaming(engine):
    """Continuous listening against a mesh-sharded catalog: the
    StreamRecognizer's incremental path routes through
    ShardedRecognizer.match_prepared and agrees with the facade's own
    full recompute."""
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.stream import CHUNK, StreamRecognizer

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        config=engine.config)
    rec_engine = ShardedRecognizer(sc)

    song = synth_song(3, duration_s=DUR, seed=31)
    clip = song[int(1.0 * 44100): int(7.0 * 44100)].astype(np.int16)
    sr = StreamRecognizer(rec_engine, channels=1, window_seconds=4.0)
    for a in range(0, len(clip) - CHUNK, CHUNK):
        sr.feed(clip[a: a + CHUNK])
    inc = sr.recognize()
    assert inc["results"][0]["song_name"] == "track000003"
    full = sr.recognize(incremental=False)
    assert inc["input_hashes"] == full["input_hashes"]
    assert (inc["results"][0]["hashes_matched_in_input"]
            == full["results"][0]["hashes_matched_in_input"])
    assert inc["results"][0]["offset"] == full["results"][0]["offset"]


def test_warmup_streams_against_sharded(engine):
    """warmup(stream_window_seconds=...) pre-compiles the /stream
    session programs against either engine shape without error."""
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.serve import warmup

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        config=engine.config)
    warmup(ShardedRecognizer(sc), seconds=2.0, max_batch=2,
           stream_window_seconds=2.0)


def test_sharded_apriori_early_exit(engine):
    """Key-range apriori: the 2x-leader exit fires on a decisive clip
    (fewer rounds than the pair count implies), the top-1 matches the
    full scan, and the mesh facade's early_exit kwarg reaches it."""
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.parallel.sharded import sharded_match_apriori

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog)
    assert sc.regime == "key_range"

    song = synth_song(1, duration_s=DUR, seed=31)
    clip = song[int(1.0 * 44100): int(7.0 * 44100)]
    fp = engine._fingerprint_channel(clip)
    q = prepare_query([fp])

    full = sc.match(q, topn=3)
    part = sc.match_apriori(q, topn=3, batch_size=128)
    assert part.results[0]["song_id"] == full.results[0]["song_id"]
    # partial-scan contract: the offset may differ from the full scan
    # (the reference's apriori results "reflect the partial scan",
    # recognizer_apriori.py:296-310) — exact parity is against the
    # single-device apriori at the same batch size, below

    # round accounting: a decisive in-catalog clip exits before the
    # last batch (n_pairs >> 128 here)
    q_frames = sc._q_frames_for(q)
    raw, used, clamped = sharded_match_apriori(
        sc.mesh, sc._shards, q, n_songs=max(sc.n_songs, 1),
        delta_min=-q_frames, delta_range=sc._delta_range_for(q_frames),
        match_capacity=sc.config.match_capacity, topn=3, batch_size=128,
        offset_stride=sc._stride, sharded_head=sc._head)
    n_batches = -(-q.n_pairs // 128)
    assert n_batches > 1
    assert used < n_batches, (used, n_batches)
    assert int(raw.top_songs[0]) == full.results[0]["song_id"]

    # EXACT parity with the single-device apriori at the same batch
    # size: identical batches -> identical partial hist per round ->
    # identical exit round and identical RawMatch
    from shazam_tpu.match.apriori import match_query_apriori
    from shazam_tpu.index.search import maybe_build_head

    dev = engine.index.device_arrays()
    raw1, used1, clamped1 = match_query_apriori(
        dev, q, n_songs=max(sc.n_songs, 1), delta_min=-q_frames,
        delta_range=sc._delta_range_for(q_frames),
        match_capacity=sc.config.match_capacity, topn=3, batch_size=128,
        offset_stride=engine.index.offset_stride,
        head=maybe_build_head(dev[0]))
    assert used1 == used and clamped1 == clamped
    for f in ("top_songs", "top_deltas", "top_votes", "row_counts",
              "total_rows", "n_ranked"):
        np.testing.assert_array_equal(
            np.asarray(getattr(raw, f)), np.asarray(getattr(raw1, f)), f)

    # facade: early_exit now reaches the partial scan on key_range
    rec = ShardedRecognizer(sc)
    out = rec.recognize_samples([clip], topn=3, early_exit=True)
    assert out["results"][0]["song_id"] == full.results[0]["song_id"]


def test_sharded_apriori_by_song_falls_back(engine):
    """The by-song regime has no partial-scan mode: match_apriori runs
    the full match and the facade warns."""
    import warnings

    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer

    mesh = make_mesh(8)
    sc = ShardedCatalog(engine.index, mesh=mesh, catalog=engine.catalog,
                        dense_limit_bytes=1)
    assert sc.regime == "by_song"
    song = synth_song(3, duration_s=DUR, seed=31)
    clip = song[int(1.0 * 44100): int(6.0 * 44100)]
    fp = engine._fingerprint_channel(clip)
    q = prepare_query([fp])
    full = sc.match(q, topn=3)
    part = sc.match_apriori(q, topn=3)
    assert part.results[0]["song_id"] == full.results[0]["song_id"]

    rec = ShardedRecognizer(sc)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = rec.recognize_samples([clip], topn=3, early_exit=True)
    assert any("key-range" in str(x.message) for x in w)
    assert out["results"][0]["song_id"] == full.results[0]["song_id"]

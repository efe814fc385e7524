"""Batched multi-query recognition == per-clip recognition."""

import numpy as np
import pytest

from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_corpus, synth_song

N_SONGS = 5
DUR = 10.0


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("bcorpus")
    files = [f for f, _ in synth_corpus(str(d), N_SONGS, duration_s=DUR, seed=11)]
    sia = SIA()
    sia.ingest_files(files, batch_size=4)
    return sia


def test_batched_matches_single(engine):
    clips = []
    for sid in range(N_SONGS):
        song = synth_song(sid, duration_s=DUR, seed=11)
        start = int((1.0 + sid) * 44100)
        clips.append(song[start : start + 5 * 44100])

    batched = engine.recognize_batch(clips, topn=3)
    assert len(batched) == N_SONGS
    for sid, out in enumerate(batched):
        single = engine.recognize_samples([clips[sid]], topn=3)
        assert out["results"][0]["song_name"] == f"track{sid:06d}"
        got = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
               for r in out["results"]]
        ref = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
               for r in single["results"]]
        assert got == ref
        assert out["total_matches"] == single["total_matches"]


def test_batched_empty():
    sia = SIA()
    assert sia.recognize_batch([]) == []


def test_batched_pad_to_pow2(engine):
    """Padding the clip axis to a power of two (serving compile
    stability) must not change any real clip's result, and must emit
    exactly len(clips) outputs."""
    clips = []
    for sid in range(3):
        song = synth_song(sid, duration_s=DUR, seed=11)
        start = int((1.0 + sid) * 44100)
        clips.append(song[start : start + 5 * 44100])

    plain = engine.recognize_batch(clips, topn=3)
    padded = engine.recognize_batch(clips, topn=3, pad_to_pow2=True)
    assert len(padded) == 3
    for a, b in zip(plain, padded):
        assert a["results"] == b["results"]
        assert a["total_matches"] == b["total_matches"]
        assert b["batch_size"] == 3


@pytest.mark.parametrize("span_rows", [0, 4096])
def test_batched_overflow_escalates(tmp_path, span_rows):
    """A clip whose expansion clamps the base tier must re-run alone
    through the escalating single-query path — results identical to
    recognize_samples, never a silently-clamped vote count."""
    from shazam_tpu.config import FingerprintConfig

    cfg = FingerprintConfig(match_capacity=64, match_capacity_fast=64,
                            match_capacity_max=4096)
    files = [f for f, _ in
             synth_corpus(str(tmp_path), 3, duration_s=8.0, seed=13)]
    sia = SIA(cfg, device_span_rows=span_rows)
    sia.ingest_files(files, batch_size=4)

    song = synth_song(1, duration_s=8.0, seed=13)
    clip = song[44100 : 44100 + 5 * 44100]
    out = sia.recognize_batch([clip], topn=2)[0]
    single = sia.recognize_samples([clip], topn=2)

    assert single["total_matches"] > 64   # genuinely past the base tier
    assert out["total_matches"] == single["total_matches"]
    assert not out["overflowed"]
    got = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
           for r in out["results"]]
    ref = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
           for r in single["results"]]
    assert got == ref


@pytest.mark.parametrize("span_rows", [0, 4096])
def test_batched_mass_overflow_redispatches_whole_batch(tmp_path,
                                                        span_rows):
    """When MOST of a batch clamps the base tier (heavily duplicated
    catalogs — the 95.3M tone corpus does this to every 5 s clip), the
    batch re-dispatches ONCE at the fitting tier instead of re-running
    each clip solo; per-clip results stay identical to
    recognize_samples."""
    from shazam_tpu.config import FingerprintConfig

    cfg = FingerprintConfig(match_capacity=64, match_capacity_fast=64,
                            match_capacity_max=4096)
    files = [f for f, _ in
             synth_corpus(str(tmp_path), 3, duration_s=8.0, seed=13)]
    sia = SIA(cfg, device_span_rows=span_rows)
    sia.ingest_files(files, batch_size=4)

    clips = [synth_song(i, duration_s=8.0, seed=13)[44100: 44100 * 6]
             for i in range(3)]
    outs = sia.recognize_batch(clips, topn=2)
    for clip, out in zip(clips, outs):
        single = sia.recognize_samples([clip], topn=2)
        assert single["total_matches"] > 64   # every clip past the tier
        assert out["total_matches"] == single["total_matches"]
        assert not out["overflowed"]
        got = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
               for r in out["results"]]
        ref = [(r["song_id"], r["offset"], r["hashes_matched_in_input"])
               for r in single["results"]]
        assert got == ref


def test_batched_sparse_equals_dense():
    """The vmapped sparse matcher must equal the vmapped dense one."""
    import jax.numpy as jnp
    import numpy as np
    from shazam_tpu.match.batched import match_queries_batched

    rng = np.random.default_rng(7)
    n, n_songs, stride = 50_000, 300, 512
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 4, n, dtype=np.uint32)
    ex = rng.integers(0, 1 << 2, n, dtype=np.uint32)
    sid = rng.integers(0, n_songs, n, dtype=np.uint32)
    off = rng.integers(0, 500, n, dtype=np.uint32)
    order = np.lexsort((off, sid, ex, lo, hi))
    cols = tuple(jnp.asarray(a[order]) for a in (hi, lo, ex))
    cols = cols + (jnp.asarray(sid[order] * np.uint32(stride) + off[order]),)

    Bq, Q = 3, 256
    qi = rng.integers(0, n, (Bq, Q))
    args = (cols,
            jnp.asarray(hi[qi]), jnp.asarray(lo[qi]), jnp.asarray(ex[qi]),
            jnp.asarray(rng.integers(0, 100, (Bq, Q)).astype(np.uint32)),
            jnp.asarray(np.ones((Bq, Q), bool)),
            jnp.asarray(np.ones((Bq, Q), bool)))
    kw = dict(n_songs=n_songs, delta_min=-128, delta_range=768,
              match_capacity=16384, topn=2, offset_stride=stride)
    dense = match_queries_batched(*args, sparse=False, **kw)
    sp = match_queries_batched(*args, sparse=True, **kw)
    for a, b in zip(sp, dense):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_batched_head_equals_headless():
    """head-seeded search under vmap (the while_loop batching rule) must
    be result-identical, dense and sparse matchers alike."""
    import jax.numpy as jnp
    from tests.test_match import _build_db, _index_from_rows, _query_from_pairs
    from shazam_tpu.index.search import build_head, head_bits_for
    from shazam_tpu.match.batched import match_queries_batched

    rng = np.random.default_rng(33)
    rows = _build_db(rng, n_songs=12, rows_per_song=800)  # ~9.6K rows
    index = _index_from_rows(rows)
    dev = index.device_arrays()
    head = build_head(dev[0], bits=head_bits_for(index.n_hashes))

    queries = []
    for sid in (3, 7, 11):
        song_rows = [r for r in rows if r[1] == sid]
        pairs = sorted({(h, max(off - 2, 0)) for h, _s, off in song_rows[:80]})
        queries.append(_query_from_pairs(pairs, pad_to=128))
    stack = {
        name: jnp.asarray(np.stack([getattr(q, name) for q in queries]))
        for name in ("hi", "lo", "ex", "t", "valid", "first")
    }
    args = tuple(stack[n] for n in ("hi", "lo", "ex", "t", "valid", "first"))
    delta_min = -(index.max_offset + 50)
    delta_range = 2 * (index.max_offset + 50)

    for sparse in (False, True):
        kw = dict(n_songs=index.n_songs, delta_min=delta_min,
                  delta_range=delta_range, match_capacity=16384, topn=3,
                  offset_stride=index.offset_stride, sparse=sparse)
        a = match_queries_batched(dev, *args, **kw)
        b = match_queries_batched(dev, *args, head=head, **kw)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_apriori_head_equals_headless():
    import jax.numpy as jnp
    from tests.test_match import _build_db, _index_from_rows, _query_from_pairs
    from shazam_tpu.index.search import build_head, head_bits_for
    from shazam_tpu.match.apriori import match_query_apriori

    rng = np.random.default_rng(37)
    rows = _build_db(rng, n_songs=10, rows_per_song=700)
    index = _index_from_rows(rows)
    dev = index.device_arrays()
    head = build_head(dev[0], bits=head_bits_for(index.n_hashes))

    song_rows = [r for r in rows if r[1] == 4]
    pairs = sorted({(h, max(off - 3, 0)) for h, _s, off in song_rows[:150]})
    q = _query_from_pairs(pairs)
    delta_min = -(index.max_offset + 50)
    delta_range = 2 * (index.max_offset + 50)
    kw = dict(n_songs=index.n_songs, delta_min=delta_min,
              delta_range=delta_range, match_capacity=16384, topn=2,
              batch_size=64, offset_stride=index.offset_stride)
    a, used_a, _ca = match_query_apriori(dev, q, **kw)
    b, used_b, _cb = match_query_apriori(dev, q, head=head, **kw)
    assert used_a == used_b
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_batched_capacity_override_identical(tmp_path):
    """recognize_batch(match_capacity=) dispatches the base at that tier
    with identical results — the serving warmup uses it to precompile
    escalated-tier programs (serve.warmup capacity_tiers)."""
    files = [f for f, _ in
             synth_corpus(str(tmp_path), 3, duration_s=8.0, seed=21)]
    sia = SIA()
    sia.ingest_files(files, batch_size=4)

    clips = [synth_song(i, duration_s=8.0, seed=21)[44100: 44100 * 5]
             for i in (0, 2)]
    base = sia.recognize_batch(clips, topn=2)
    hi = sia.recognize_batch(clips, topn=2,
                             match_capacity=4 * sia.config.match_capacity)
    for a, b in zip(base, hi):
        assert a["results"] == b["results"]
        assert a["total_matches"] == b["total_matches"]


def test_warmup_capacity_tiers_smoke(tmp_path):
    """warmup(capacity_tiers=...) runs the tier programs end to end."""
    from shazam_tpu.serve import warmup

    files = [f for f, _ in
             synth_corpus(str(tmp_path), 2, duration_s=6.0, seed=22)]
    sia = SIA()
    sia.ingest_files(files, batch_size=2)
    warmup(sia, seconds=2.0, max_batch=2, pair_buckets=(),
           capacity_tiers=(sia.config.match_capacity * 4,))


def test_warmup_pinned_tier_shares_live_programs(tmp_path):
    """A warmup call that PINS a tier (explicit match_capacity) and a
    live call whose bounds-first probe lands on that same tier must hit
    the SAME compiled batch program.  Before the fix, explicit
    match_capacity skipped the probe, so warmup compiled bounds=None
    variants while live traffic ran bounds-carrying programs — every
    warmed tier recompiled inside a live request."""
    import dataclasses

    from shazam_tpu.config import DEFAULT_CONFIG
    from shazam_tpu.match import batched as mb

    # force the production bounds-first path on a toy index (the pinned
    # serving flow probes for bounds regardless of policy; the LIVE
    # unpinned comparison call needs "bounds" so its probe picks the
    # pinned tier rather than decided-first's no-probe base dispatch)
    cfg = dataclasses.replace(DEFAULT_CONFIG, bounds_probe_min_rows=1,
                              sparse_vote_threshold=0,
                              escalation_policy="bounds")
    files = [f for f, _ in
             synth_corpus(str(tmp_path), 3, duration_s=8.0, seed=23)]
    sia = SIA(config=cfg)
    sia.ingest_files(files, batch_size=4)

    clips = [synth_song(i, duration_s=8.0, seed=23)[44100: 44100 * 5]
             for i in (0, 1)]
    if not hasattr(mb.match_queries_batched, "_cache_size"):
        pytest.skip("jax.jit no longer exposes _cache_size (private "
                    "API); the compile-count assertion needs a "
                    "replacement hook")
    # warmup style: tier pinned at the ladder's first tier (the tier a
    # toy corpus's probe always fits in — totals are far below it)
    warm = sia.recognize_batch(clips, topn=2,
                               match_capacity=sia._match_tiers()[0])
    n_warm = mb.match_queries_batched._cache_size()
    # live style: probe picks the fitting tier (== the pinned one)
    live = sia.recognize_batch(clips, topn=2)
    assert mb.match_queries_batched._cache_size() == n_warm, \
        "live dispatch compiled a new batch program after warmup"
    for a, b in zip(warm, live):
        assert a["results"] == b["results"]
        assert a["total_matches"] == b["total_matches"]


def test_sliced_fingerprint_download_equivalence(tmp_path):
    """prepare_batch downloads only the live hash prefix for big
    batches (>= 2^20 padded elements — the serving shape); results must
    be identical to the solo path."""
    files = [f for f, _ in
             synth_corpus(str(tmp_path), 4, duration_s=6.0, seed=41)]
    sia = SIA()
    sia.ingest_files(files, batch_size=4)

    clips = [synth_song(i % 4, duration_s=6.0, seed=41)
             [44100 + 1000 * i: 44100 * 4 + 1000 * i] for i in range(32)]
    assert 32 * sia.config.hash_capacity >= (1 << 20), \
        "batch must trip the sliced-download gate"
    pb = sia.prepare_batch(clips, topn=2)
    # the slice actually engaged: stacked query columns exist and the
    # per-clip queries came from the truncated columns
    outs = sia.match_prepared_batch(pb)
    for i in (0, 7, 31):
        solo = sia.recognize_samples([clips[i]], topn=2)
        assert (outs[i]["results"][0]["song_name"]
                == solo["results"][0]["song_name"] == f"track{i % 4:06d}")
        assert outs[i]["total_matches"] == solo["total_matches"]
        assert outs[i]["input_hashes"] == solo["input_hashes"]

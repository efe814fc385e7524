"""Spanned device store (index/devmerge.SpannedDeviceStore).

Past ~150M hashes a single DeviceIndex's finalize sort outgrows a 16 GB
device's headroom (capacity-doubled buffer + sort scratch), so the index
becomes multiple bounded sorted spans queried together.  The contract: a spanned store is
ELEMENT-IDENTICAL to the single store — same host index after ingest,
same recognition results — regardless of how rows land across spans.
Matches the scale of the reference's largest recorded deployment
(436,682,654 hashes, ``fingerprints_queries.sql:3``).
"""

import numpy as np
import pytest


def _songs(n, secs=3.0):
    from shazam_tpu.audio.synth import synth_song

    return [(f"s{i}", synth_song(i, duration_s=secs, seed=11))
            for i in range(n)]


def _pad_batch(arrs):
    import jax.numpy as jnp

    blen = 1 << 18
    mat = np.zeros((len(arrs), blen), np.float32)
    nv = []
    for i, a in enumerate(arrs):
        mat[i, : len(a)] = a
        nv.append(len(a))
    return jnp.asarray(mat), nv


def _index_equal(a, b):
    for fa, fb in ((a.key_hi, b.key_hi), (a.key_lo, b.key_lo),
                   (a.key_ex, b.key_ex), (a.song_id, b.song_id),
                   (a.offset, b.offset)):
        assert np.array_equal(np.asarray(fa), np.asarray(fb))
    assert a.n_songs == b.n_songs


# --------------------------------------------------------------------- #
# matcher parity: spanned == flat on the same rows
# --------------------------------------------------------------------- #

def _random_index(n_rows, n_songs, stride, seed=0):
    rng = np.random.default_rng(seed)
    hi = np.sort(rng.integers(0, 2**32, n_rows, dtype=np.uint32))
    lo = rng.integers(0, 2**32, n_rows, dtype=np.uint32)
    ex = rng.integers(0, 2**16, n_rows, dtype=np.uint32)
    sid = rng.integers(0, n_songs, n_rows, dtype=np.uint32)
    off = rng.integers(0, stride, n_rows, dtype=np.uint32)
    order = np.lexsort((off, sid, ex, lo, hi))
    return hi[order], lo[order], ex[order], sid[order], off[order]


@pytest.mark.parametrize("n_spans", [1, 3])
def test_spanned_matcher_equals_flat(n_spans):
    import jax.numpy as jnp
    from shazam_tpu.index.search import maybe_build_head
    from shazam_tpu.match.lookup import (match_query_sparse,
                                         match_query_sparse_spanned)

    n_rows, n_songs, stride = 30000, 40, 4096
    hi, lo, ex, sid, off = _random_index(n_rows, n_songs, stride)
    packed = sid * np.uint32(stride) + off
    flat = tuple(jnp.asarray(a) for a in (hi, lo, ex, packed))

    # round-robin partition: every span holds the full key range (a
    # subsequence of a sorted array is sorted), mimicking ingest-time
    # spans whose key ranges fully overlap
    spans = tuple(
        tuple(jnp.asarray(a[k::n_spans]) for a in (hi, lo, ex, packed))
        for k in range(n_spans)
    )
    heads = tuple(maybe_build_head(s[0]) for s in spans)

    rng = np.random.default_rng(7)
    q_n = 256
    pick = rng.integers(0, n_rows, q_n)
    q = dict(
        q_hi=jnp.asarray(hi[pick]), q_lo=jnp.asarray(lo[pick]),
        q_ex=jnp.asarray(ex[pick]),
        q_t=jnp.asarray(rng.integers(0, 50, q_n).astype(np.uint32)),
        q_valid=jnp.asarray(np.ones(q_n, bool)),
        q_first=jnp.asarray(np.ones(q_n, bool)),
    )
    kw = dict(n_songs=n_songs, delta_min=-64,
              delta_range=stride + 128, match_capacity=16384, topn=5,
              offset_stride=stride)

    ref = match_query_sparse(flat, *q.values(),
                             head=maybe_build_head(flat[0]), **kw)
    got, span_max = match_query_sparse_spanned(spans, *q.values(),
                                               heads=heads, **kw)
    assert int(got.total_rows) == int(ref.total_rows)
    assert int(span_max) <= int(ref.total_rows)
    np.testing.assert_array_equal(np.asarray(got.top_songs),
                                  np.asarray(ref.top_songs))
    np.testing.assert_array_equal(np.asarray(got.top_votes),
                                  np.asarray(ref.top_votes))
    np.testing.assert_array_equal(np.asarray(got.top_deltas),
                                  np.asarray(ref.top_deltas))
    np.testing.assert_array_equal(np.asarray(got.row_counts),
                                  np.asarray(ref.row_counts))


# --------------------------------------------------------------------- #
# store: device ingest across span rolls == single store
# --------------------------------------------------------------------- #

def test_spanned_device_ingest_matches_single():
    from shazam_tpu.api import SIA
    from shazam_tpu.index.devmerge import SpannedDeviceStore

    songs = _songs(6)

    single = SIA(device_resident=True)
    spanned = SIA(device_resident=True, device_span_rows=4096)

    for sia in (single, spanned):
        # 2-song batches with a tight per-song capacity keep every
        # appended run under span_rows; 6 songs x ~600 hashes roll
        # the 4096-row spans at least once
        for i in range(0, len(songs), 2):
            chunk = songs[i:i + 2]
            batch, nv = _pad_batch([s for _n, s in chunk])
            stats = sia.ingest_device_batch(
                [n for n, _s in chunk], batch, nv,
                per_song_hash_capacity=4096, defer_sort=True)
            assert stats["overflowed"] == []

    store = spanned._dev_store
    assert isinstance(store, SpannedDeviceStore)
    assert len(store.spans) >= 2, "test must exercise a span roll"
    _index_equal(single.index, spanned.index)

    clip = songs[3][1][11025: 11025 + 2 * 44100]
    out_s = single.recognize_samples([clip])
    out_p = spanned.recognize_samples([clip])
    assert out_p["results"][0]["song_name"] == "s3"
    assert (out_p["results"][0]["hashes_matched_in_input"]
            == out_s["results"][0]["hashes_matched_in_input"])
    assert out_p["total_matches"] == out_s["total_matches"]

    # single-dispatch path agrees too
    clip_out = spanned.recognize_clip(clip)
    assert clip_out["results"][0]["song_name"] == "s3"
    assert (clip_out["results"][0]["hashes_matched_in_input"]
            == out_s["results"][0]["hashes_matched_in_input"])

    # batch serving API (per-clip spanned fallback)
    outs = spanned.recognize_batch([clip, songs[1][1][: 44100]])
    assert outs[0]["results"][0]["song_name"] == "s3"
    assert outs[1]["results"][0]["song_name"] == "s1"


def test_spanned_host_ingest_and_from_host():
    """Host-path merge absorption + from_host span splitting."""
    from shazam_tpu.api import SIA

    songs = _songs(10)

    host = SIA()
    host.ingest_arrays(songs)

    # host ingest into a spanned store (absorb via chunked span merges)
    spanned = SIA(device_resident=True, device_span_rows=4096)
    spanned.ingest_arrays(songs)
    _index_equal(host.index, spanned.index)

    # from_host: preload an existing index into spans, then recognize
    pre = SIA(index=host.index, device_resident=True,
              device_span_rows=4096)
    pre.catalog = host.catalog  # same song ids as the preloaded index
    store = pre._ensure_dev_store()
    assert len(store.spans) >= 2
    clip = songs[2][1][22050: 22050 + 2 * 44100]
    out = pre.recognize_samples([clip])
    ref = host.recognize_samples([clip])
    assert out["results"][0]["song_name"] == "s2"
    assert (out["results"][0]["hashes_matched_in_input"]
            == ref["results"][0]["hashes_matched_in_input"])
    assert out["total_matches"] == ref["total_matches"]


def test_stacked_matcher_equals_flat():
    """Consolidated (n_spans, span_rows) layout: same results as flat."""
    import jax
    import jax.numpy as jnp
    from shazam_tpu.index.search import build_head, stacked_head_bits, \
        maybe_build_head
    from shazam_tpu.match.lookup import (match_query_sparse,
                                         match_query_sparse_spanned)

    n_rows, n_songs, stride, n_spans = 30000, 40, 4096, 3
    hi, lo, ex, sid, off = _random_index(n_rows, n_songs, stride, seed=1)
    packed = sid * np.uint32(stride) + off
    flat = tuple(jnp.asarray(a) for a in (hi, lo, ex, packed))

    # equal-capacity spans: round-robin + sentinel-pad to one length
    span_rows = -(-n_rows // n_spans)
    def spanify(a):
        rows = []
        for k in range(n_spans):
            part = a[k::n_spans]
            rows.append(np.concatenate(
                [part, np.full(span_rows - len(part), 0xFFFFFFFF,
                               np.uint32)]))
        return jnp.asarray(np.stack(rows))
    stacked = tuple(spanify(a) for a in (hi, lo, ex, packed))
    bits = stacked_head_bits(span_rows)
    heads = jax.vmap(lambda h: build_head(h, bits=bits))(stacked[0])

    rng = np.random.default_rng(9)
    q_n = 256
    pick = rng.integers(0, n_rows, q_n)
    valid = np.ones(q_n, bool)
    valid[200:] = False          # padding lanes exercise q_valid
    q = dict(
        q_hi=jnp.asarray(hi[pick]), q_lo=jnp.asarray(lo[pick]),
        q_ex=jnp.asarray(ex[pick]),
        q_t=jnp.asarray(rng.integers(0, 50, q_n).astype(np.uint32)),
        q_valid=jnp.asarray(valid), q_first=jnp.asarray(valid),
    )
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=16384, topn=5, offset_stride=stride)

    ref = match_query_sparse(flat, *q.values(),
                             head=maybe_build_head(flat[0]), **kw)
    got, span_max = match_query_sparse_spanned(stacked, *q.values(),
                                               heads=heads, **kw)
    assert int(got.total_rows) == int(ref.total_rows)
    assert int(span_max) <= int(ref.total_rows)
    for f in ("top_songs", "top_votes", "top_deltas", "row_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))


def test_consolidate_store_end_to_end():
    """SpannedDeviceStore.consolidate(): same recognition, ingest raises."""
    from shazam_tpu.api import SIA

    songs = _songs(6)
    sia = SIA(device_span_rows=4096)
    for i in range(0, len(songs), 2):
        chunk = songs[i:i + 2]
        batch, nv = _pad_batch([s for _n, s in chunk])
        sia.ingest_device_batch([n for n, _s in chunk], batch, nv,
                                per_song_hash_capacity=4096,
                                defer_sort=True)
    clip = songs[4][1][11025: 11025 + 2 * 44100]
    before = sia.recognize_samples([clip])
    host_before = sia.index    # host sync BEFORE consolidation

    store = sia._ensure_dev_store()
    n_spans = len([s for s in store.spans if s.n_valid > 0])
    assert n_spans >= 2
    store.consolidate()
    sia._host_stale = True     # force to_host through the stacked layout
    assert store.is_stacked and store.query_cols()[0].ndim == 2

    after = sia.recognize_samples([clip])
    assert after["results"][0]["song_name"] == "s4"
    assert (after["results"][0]["hashes_matched_in_input"]
            == before["results"][0]["hashes_matched_in_input"])
    assert after["total_matches"] == before["total_matches"]

    clip_out = sia.recognize_clip(clip)
    assert clip_out["results"][0]["song_name"] == "s4"
    assert (clip_out["results"][0]["hashes_matched_in_input"]
            == before["results"][0]["hashes_matched_in_input"])

    outs = sia.recognize_batch([clip, songs[1][1][:44100]])
    assert outs[0]["results"][0]["song_name"] == "s4"
    assert (outs[0]["results"][0]["hashes_matched_in_input"]
            == before["results"][0]["hashes_matched_in_input"])
    assert outs[1]["results"][0]["song_name"] == "s1"

    _index_equal(host_before, sia.index)   # stacked to_host round trip

    batch, nv = _pad_batch([songs[0][1]])
    with pytest.raises(ValueError, match="consolidated"):
        sia.ingest_device_batch(["fresh"], batch, nv,
                                per_song_hash_capacity=4096,
                                defer_sort=True)


def test_spanned_lifecycle_delete_save_reload(tmp_path):
    """delete_songs / save_index / load_index across the host-sync
    boundary of a spanned store (DELETE_SONGS cascade parity,
    ``mysql_database.py:52-58,136-138``)."""
    from shazam_tpu.api import SIA

    songs = _songs(6)
    sia = SIA(device_span_rows=4096)   # implies device_resident
    assert sia.device_resident
    sia.ingest_arrays(songs)
    n0 = sia.index.n_hashes

    sid3 = next(r["song_id"] for r in sia.catalog.get_songs()
                if r["song_name"] == "s3")
    removed = sia.delete_songs([sid3])
    assert 0 < removed < n0
    assert sia.index.n_hashes == n0 - removed
    assert not np.isin(sia.index.song_id, [sid3]).any()

    path = str(tmp_path / "ix.npz")
    sia.save_index(path)

    fresh = SIA(device_span_rows=4096)
    fresh.catalog = sia.catalog
    fresh.load_index(path)
    clip = songs[1][1][11025: 11025 + 2 * 44100]
    out = fresh.recognize_samples([clip])
    assert out["results"][0]["song_name"] == "s1"
    # the deleted song can't match
    clip3 = songs[3][1][11025: 11025 + 2 * 44100]
    out3 = fresh.recognize_samples([clip3])
    assert (not out3["results"]
            or out3["results"][0]["song_name"] != "s3")


def test_spanned_run_too_large_raises():
    from shazam_tpu.index.devmerge import SENTINEL, SpannedDeviceStore
    import jax.numpy as jnp

    store = SpannedDeviceStore(span_rows=4096, n_songs=1, max_offset=100,
                               stride=128)
    cols = tuple(jnp.full(8192, SENTINEL, jnp.uint32) for _ in range(4))
    with pytest.raises(ValueError, match="exceeds span_rows"):
        store.append_run(cols, 8000, 1, 100)


# --------------------------------------------------------------------- #
# span-wise persistence: save/load without a global sort
# --------------------------------------------------------------------- #

def test_spanned_save_load_roundtrip(tmp_path):
    """Span-wise save -> load is element-identical to the live store,
    at the saved span_rows AND re-split to a smaller one."""
    from shazam_tpu.index.devmerge import (SpannedDeviceStore,
                                           is_spanned_file)
    from shazam_tpu.index.store import build_index

    hi, lo, ex, sid, off = _random_index(20_000, 12, 512, seed=3)
    ix = build_index(
        [(s, hi[sid == s], lo[sid == s], ex[sid == s], off[sid == s])
         for s in range(12)], n_songs=12)
    store = SpannedDeviceStore.from_host(ix, span_rows=8192)
    path = str(tmp_path / "span.npz")
    store.save(path)
    assert is_spanned_file(path)
    assert not is_spanned_file(str(tmp_path / "missing.npz"))

    back = SpannedDeviceStore.load(path)
    assert back.span_rows == 8192
    assert back.n_valid == store.n_valid
    assert back.stride == store.stride
    _index_equal(back.to_host(), store.to_host())

    # re-split into smaller spans: each saved span is sorted, so the
    # slices keep the per-span invariant and the flat view is unchanged
    resplit = SpannedDeviceStore.load(path, span_rows=4096)
    assert resplit.span_rows == 4096
    assert len(resplit.spans) > len(back.spans)
    _index_equal(resplit.to_host(), store.to_host())

    # load_flat: one sorted host index, no device arrays
    _index_equal(SpannedDeviceStore.load_flat(path), store.to_host())


def test_spanned_save_load_api_roundtrip(tmp_path):
    """SIA.save_index on a spanned store writes the span-wise format;
    load_index restores it into spanned AND flat SIAs, still growable
    and queryable."""
    from shazam_tpu.api import SIA
    from shazam_tpu.index.devmerge import is_spanned_file

    songs = _songs(5)
    sia = SIA(device_span_rows=4096)
    sia.ingest_arrays(songs[:4])
    flat_before = sia.index   # forces the host sync

    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    assert is_spanned_file(path)

    fresh = SIA(device_span_rows=4096)
    fresh.catalog = sia.catalog
    fresh.load_index(path)
    _index_equal(fresh.index, flat_before)
    clip = songs[2][1][11025: 11025 + 2 * 44100]
    assert fresh.recognize_samples([clip])["results"][0]["song_name"] == "s2"

    # the loaded store keeps growing (append into the restored spans)
    fresh.ingest_arrays(songs[4:])
    clip4 = songs[4][1][11025: 11025 + 2 * 44100]
    assert fresh.recognize_samples([clip4])["results"][0]["song_name"] == "s4"

    # a non-spanned SIA consumes the same file via the host flatten
    flat_sia = SIA()
    flat_sia.catalog = sia.catalog
    flat_sia.load_index(path)
    _index_equal(flat_sia.index, flat_before)
    assert flat_sia.recognize_samples([clip])["results"][0]["song_name"] == "s2"


def test_consolidated_save_load(tmp_path):
    """A consolidated (stacked) store saves span-wise and reloads in the
    per-span layout, re-consolidatable."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore
    from shazam_tpu.index.store import build_index

    hi, lo, ex, sid, off = _random_index(12_000, 6, 512, seed=9)
    ix = build_index(
        [(s, hi[sid == s], lo[sid == s], ex[sid == s], off[sid == s])
         for s in range(6)], n_songs=6)
    store = SpannedDeviceStore.from_host(ix, span_rows=4096)
    flat = store.to_host()
    store.consolidate()
    path = str(tmp_path / "cons.npz")
    store.save(path)

    back = SpannedDeviceStore.load(path)
    assert not back.is_stacked
    _index_equal(back.to_host(), flat)
    back.consolidate()
    assert back.is_stacked
    _index_equal(back.to_host(), flat)


def test_empty_spanned_save_load(tmp_path):
    """An empty spanned store round-trips (no span entries in the file)
    and stays usable for ingest after load."""
    from shazam_tpu.index.devmerge import SpannedDeviceStore

    store = SpannedDeviceStore(span_rows=4096)
    path = str(tmp_path / "empty.npz")
    store.save(path)
    back = SpannedDeviceStore.load(path)
    assert back.n_valid == 0
    assert back.to_host().n_hashes == 0
    flat = SpannedDeviceStore.load_flat(path)
    assert flat.n_hashes == 0


def test_consolidate_rollback_on_midway_fault(monkeypatch):
    """A fault while stacking a LATER column must leave the per-span
    layout whole (the docstring contract): released source columns are
    restored from their stacked copies, queries keep working, and a
    retry consolidates cleanly."""
    from shazam_tpu import index as _index_pkg
    from shazam_tpu.api import SIA
    from shazam_tpu.index import devmerge

    songs = _songs(8)
    sia = SIA(device_span_rows=4096)
    for i in range(0, len(songs), 2):
        chunk = songs[i:i + 2]
        batch, nv = _pad_batch([s for _n, s in chunk])
        sia.ingest_device_batch([n for n, _s in chunk], batch, nv,
                                per_song_hash_capacity=4096,
                                defer_sort=True)
    clip = songs[2][1][11025: 11025 + 2 * 44100]
    before = sia.recognize_samples([clip])
    assert before["results"][0]["song_name"] == "s2"

    store = sia._ensure_dev_store()
    n_live = len([s for s in store.spans if s.n_valid > 0])
    assert n_live >= 2

    # fail after the FIRST column fully stacked (its sources released)
    real = devmerge._stack_row
    calls = {"n": 0}

    def flaky(big, row, i):
        calls["n"] += 1
        if calls["n"] > n_live:
            raise RuntimeError("injected device fault")
        return real(big, row, i)

    monkeypatch.setattr(devmerge, "_stack_row", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        store.consolidate()
    monkeypatch.setattr(devmerge, "_stack_row", real)

    # per-span layout whole: no None columns, not stacked, queries work
    assert not store.is_stacked
    for s in store.spans:
        assert all(c is not None for c in s.cols)
    sia._device_index = None  # drop any cached handles
    mid = sia.recognize_samples([clip])
    assert mid["results"][0]["song_name"] == "s2"
    assert mid["results"] == before["results"]

    # retry succeeds and still matches
    store.consolidate()
    assert store.is_stacked
    sia._device_index = None
    after = sia.recognize_samples([clip])
    assert after["results"] == before["results"]


def test_stacked_load_equals_consolidate(tmp_path):
    """load(stacked=True) builds the consolidated serving layout
    directly from the snapshot — element-identical to load +
    consolidate() (which needs catalog + one extra column of HBM and
    OOMs at 436M hashes), including under a re-split span_rows."""
    import numpy as _np
    from shazam_tpu.index.devmerge import SpannedDeviceStore
    from shazam_tpu.index.store import build_index

    hi, lo, ex, sid, off = _random_index(12_000, 6, 512, seed=21)
    ix = build_index(
        [(s, hi[sid == s], lo[sid == s], ex[sid == s], off[sid == s])
         for s in range(6)], n_songs=6)
    store = SpannedDeviceStore.from_host(ix, span_rows=8192)
    flat = store.to_host()
    path = str(tmp_path / "span.npz")
    store.save(path)

    for rows in (0, 4096):   # saved span_rows and a re-split
        ref = SpannedDeviceStore.load(path, span_rows=rows)
        ref.consolidate()
        got = SpannedDeviceStore.load(path, span_rows=rows, stacked=True)
        assert got.is_stacked
        assert got._stacked_valids == ref._stacked_valids
        assert got.n_valid == store.n_valid
        for a, b in zip(got.query_cols(), ref.query_cols()):
            assert _np.array_equal(_np.asarray(a), _np.asarray(b))
        _index_equal(got.to_host(), flat)


def test_stacked_load_api_end_to_end(tmp_path):
    """SIA.load_index(stacked=True): recognition works against the
    directly-loaded stacked layout; ingest into it raises (terminal),
    like any consolidated store."""
    from shazam_tpu.api import SIA

    songs = _songs(5)
    sia = SIA(device_span_rows=4096)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    clip = songs[2][1][11025: 11025 + 2 * 44100]
    before = sia.recognize_samples([clip])
    assert before["results"][0]["song_name"] == "s2"

    fresh = SIA(device_span_rows=4096)
    fresh.catalog = sia.catalog
    fresh.load_index(path, stacked=True)
    assert fresh._dev_store.is_stacked
    after = fresh.recognize_samples([clip])
    assert after["results"][0]["song_name"] == "s2"
    assert after["results"] == before["results"]
    # fresh CONTENT (same audio would hit the SHA-1 resume dedup and
    # never reach the store)
    new_audio = np.concatenate([songs[0][1], songs[1][1]])
    with pytest.raises(ValueError, match="consolidated"):
        fresh.ingest_arrays([("s9", new_audio)])


def test_consolidate_oom_falls_back_to_host_staging(monkeypatch):
    """RESOURCE_EXHAUSTED from the device-direct stacking path falls
    back to host staging (download sources -> release -> upload stacked)
    and still produces the exact stacked layout."""
    import jax
    import numpy as _np
    from shazam_tpu.index import devmerge
    from shazam_tpu.index.devmerge import SpannedDeviceStore
    from shazam_tpu.index.store import build_index

    hi, lo, ex, sid, off = _random_index(9_000, 6, 512, seed=33)
    ix = build_index(
        [(s, hi[sid == s], lo[sid == s], ex[sid == s], off[sid == s])
         for s in range(6)], n_songs=6)
    ref = SpannedDeviceStore.from_host(ix, span_rows=4096)
    ref.consolidate()

    store = SpannedDeviceStore.from_host(ix, span_rows=4096)

    def oom(big, row, i):
        raise jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate")

    monkeypatch.setattr(devmerge, "_stack_row", oom)
    store.consolidate()   # device path raises, host staging finishes
    assert store.is_stacked
    assert store._stacked_valids == ref._stacked_valids
    for a, b in zip(store.query_cols(), ref.query_cols()):
        assert _np.array_equal(_np.asarray(a), _np.asarray(b))


def test_spanned_single_dispatch_vote_key_guard():
    """recognize_on_device_spanned raises on int32 vote-key overflow like
    every other matcher entry point (silent wrap = wrong songs)."""
    import jax.numpy as jnp
    from shazam_tpu.match.ondevice import recognize_on_device_spanned

    dummy = jnp.zeros(1, jnp.uint32)
    with pytest.raises(ValueError, match="int32 vote key"):
        recognize_on_device_spanned(
            jnp.zeros((1, 1 << 18), jnp.float32), jnp.asarray([100], jnp.int32),
            ((dummy, dummy, dummy, dummy),),
            fs=44100, wsize=4096, hop=2048, amp_min=10.0, radius=10,
            fan_value=5, min_dt=0, max_dt=200,
            n_songs=1 << 20, delta_min=-1024, delta_range=4608,
            offset_stride=0,
        )


def test_spanned_torn_delete_reconciles_on_load(tmp_path):
    """An online delete without --persist leaves the spanned snapshot
    holding the deleted song's rows while sqlite already dropped the
    catalog row. The spanned load path gates a reconcile on the cheap
    hash-sum invariant (catalog n_hashes == store n_valid), so the
    deleted song cannot resurface under a bare numeric name."""
    from shazam_tpu.api import SIA

    songs = _songs(5)
    cat = str(tmp_path / "cat.sqlite")
    sia = SIA(device_span_rows=4096, catalog_path=cat)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)              # snapshot BEFORE the delete
    sid2 = next(r["song_id"] for r in sia.catalog.get_songs()
                if r["song_name"] == "s2")
    sia.delete_songs([sid2])          # sqlite commits; snapshot is stale
    sia.catalog.close()

    fresh = SIA(device_span_rows=4096, catalog_path=cat)
    fresh.load_index(path)
    clip2 = songs[2][1][11025: 11025 + 2 * 44100]
    out = fresh.recognize_samples([clip2])
    assert all(r["song_id"] != sid2 for r in out["results"])
    clip1 = songs[1][1][11025: 11025 + 2 * 44100]
    out1 = fresh.recognize_samples([clip1])
    assert out1["results"][0]["song_name"] == "s1"


def test_stacked_joint_budget_clamp_and_escalation():
    """The stacked layout shares ONE match_capacity budget across spans
    (lookup._expand_stacked): the clamp signal is the global total, the
    shortest-first run budget drops whole runs (n_dropped counts them),
    and escalating to a capacity that fits the total reproduces the flat
    matcher exactly."""
    import jax
    import jax.numpy as jnp
    from shazam_tpu.index.search import build_head, stacked_head_bits, \
        maybe_build_head
    from shazam_tpu.match.lookup import (match_query_sparse,
                                         match_query_sparse_spanned)

    n_rows, n_songs, stride, n_spans = 30000, 40, 4096, 3
    hi, lo, ex, sid, off = _random_index(n_rows, n_songs, stride, seed=3)
    # hot keys: repeat one key across many rows so runs are long enough
    # that a small budget must drop some
    hot = n_rows // 4
    hi[:hot] = hi[hot]
    lo[:hot] = lo[hot]
    ex[:hot] = ex[hot]
    order = np.lexsort((off, sid, ex, lo, hi))
    hi, lo, ex, sid, off = (a[order] for a in (hi, lo, ex, sid, off))
    packed = sid * np.uint32(stride) + off
    flat = tuple(jnp.asarray(a) for a in (hi, lo, ex, packed))

    span_rows = -(-n_rows // n_spans)

    def spanify(a):
        rows = []
        for k in range(n_spans):
            part = a[k::n_spans]
            rows.append(np.concatenate(
                [part, np.full(span_rows - len(part), 0xFFFFFFFF,
                               np.uint32)]))
        return jnp.asarray(np.stack(rows))

    stacked = tuple(spanify(a) for a in (hi, lo, ex, packed))
    bits = stacked_head_bits(span_rows)
    heads = jax.vmap(lambda h: build_head(h, bits=bits))(stacked[0])

    rng = np.random.default_rng(11)
    q_n = 128
    pick = rng.integers(0, n_rows, q_n)
    pick[:8] = hot                     # guarantee hot-run hits
    q = dict(
        q_hi=jnp.asarray(hi[pick]), q_lo=jnp.asarray(lo[pick]),
        q_ex=jnp.asarray(ex[pick]),
        q_t=jnp.asarray(rng.integers(0, 50, q_n).astype(np.uint32)),
        q_valid=jnp.asarray(np.ones(q_n, bool)),
        q_first=jnp.asarray(np.ones(q_n, bool)),
    )
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              topn=5, offset_stride=stride)

    small, clamp = match_query_sparse_spanned(
        stacked, *q.values(), heads=heads, match_capacity=2048, **kw)
    total = int(small.total_rows)
    assert total > 2048, "test setup must overflow the small budget"
    assert int(clamp) == total          # global-total clamp signal
    assert int(small.n_dropped) > 0     # whole runs were dropped

    cap = 4096
    while cap < total:
        cap *= 2
    big, clamp2 = match_query_sparse_spanned(
        stacked, *q.values(), heads=heads, match_capacity=cap, **kw)
    assert int(clamp2) == total and int(big.n_dropped) == 0

    ref = match_query_sparse(flat, *q.values(),
                             head=maybe_build_head(flat[0]),
                             match_capacity=cap, **kw)
    for f in ("top_songs", "top_votes", "top_deltas", "row_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(big, f)),
                                      np.asarray(getattr(ref, f)))

    # the candidate-pruned spanned matcher (in-program cond fallback)
    # must agree element-identically at every candidate count
    from shazam_tpu.match.lookup import match_query_pruned_spanned
    for n_cand in (2, 16, n_songs):
        pruned, clamp_p, _ok = match_query_pruned_spanned(
            stacked, *q.values(), heads=heads, match_capacity=cap,
            n_candidates=n_cand, **kw)
        assert int(clamp_p) == total
        for a, b in zip(pruned, big):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stacked_uview_matcher_equals_heads():
    """Stacked unique-key view (build_unique_view_spans): the spanned
    matcher returns element-identical results through the uview and the
    bucket-CDF heads."""
    import jax
    import jax.numpy as jnp
    from shazam_tpu.index.search import (build_head, stacked_head_bits,
                                         build_unique_view_spans)
    from shazam_tpu.match.lookup import match_query_sparse_spanned

    n_rows, n_songs, stride, n_spans = 30000, 40, 4096, 3
    hi, lo, ex, sid, off = _random_index(n_rows, n_songs, stride, seed=3)
    packed = sid * np.uint32(stride) + off

    span_rows = -(-n_rows // n_spans)
    parts = []

    def spanify(a):
        rows = []
        for k in range(n_spans):
            part = a[k::n_spans]
            rows.append(np.concatenate(
                [part, np.full(span_rows - len(part), 0xFFFFFFFF,
                               np.uint32)]))
        return jnp.asarray(np.stack(rows))

    stacked = tuple(spanify(a) for a in (hi, lo, ex, packed))
    for k in range(n_spans):
        parts.append((hi[k::n_spans], lo[k::n_spans], ex[k::n_spans]))
    bits = stacked_head_bits(span_rows)
    heads = jax.vmap(lambda h: build_head(h, bits=bits))(stacked[0])
    uview, usteps = build_unique_view_spans(parts)
    assert uview is not None and usteps > 0

    rng = np.random.default_rng(11)
    q_n = 128
    pick = rng.integers(0, n_rows, q_n)
    valid = np.ones(q_n, bool)
    valid[100:] = False
    q_hi = hi[pick].copy()
    q_hi[100:] = 0xFFFFFFFF        # padding lanes: all-ones keys
    q = dict(
        q_hi=jnp.asarray(q_hi), q_lo=jnp.asarray(lo[pick]),
        q_ex=jnp.asarray(ex[pick]),
        q_t=jnp.asarray(rng.integers(0, 50, q_n).astype(np.uint32)),
        q_valid=jnp.asarray(valid), q_first=jnp.asarray(valid),
    )
    kw = dict(n_songs=n_songs, delta_min=-64, delta_range=stride + 128,
              match_capacity=16384, topn=5, offset_stride=stride)

    ref, sm_ref = match_query_sparse_spanned(stacked, *q.values(),
                                             heads=heads, **kw)
    got, sm_got = match_query_sparse_spanned(stacked, *q.values(),
                                             uviews=uview, u_steps=usteps,
                                             **kw)
    assert int(sm_got) == int(sm_ref)
    for f in ("top_songs", "top_votes", "top_deltas", "row_counts",
              "total_rows", "n_ranked", "n_dropped", "runner_votes"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)


def test_stacked_load_builds_uview(tmp_path):
    """load_index(stacked=True) builds the stacked unique-key view from
    the snapshot's host rows, and recognition through it matches the
    per-span store exactly."""
    from shazam_tpu.api import SIA

    songs = _songs(8, secs=10.0)
    sia = SIA(device_span_rows=8192)
    sia.ingest_arrays(songs)
    path = str(tmp_path / "ix.npz")
    sia.save_index(path)
    clip = songs[3][1][11025: 11025 + 3 * 44100]
    before = sia.recognize_samples([clip])
    assert before["results"][0]["song_name"] == "s3"

    fresh = SIA(device_span_rows=8192)
    fresh.catalog = sia.catalog
    fresh.load_index(path, stacked=True)
    view, steps = fresh._dev_store.uview
    assert view is not None and steps > 0
    after = fresh.recognize_samples([clip])
    assert after["results"] == before["results"]
    # the single-dispatch and batched paths ride the uview too
    one = fresh.recognize_clip(clip)
    assert one["results"][0]["song_name"] == "s3"
    outs = fresh.recognize_batch([clip, songs[1][1][11025: 11025 + 3 * 44100]])
    assert outs[0]["results"][0]["song_name"] == "s3"
    assert outs[1]["results"][0]["song_name"] == "s1"


def test_spanned_bounds_first_and_blocked_match_default():
    """Spanned bounds-first policy (probe -> fitting tier) + the stacked
    blocked expansion produce IDENTICAL recognition to the default
    fast-tier-first path on a consolidated store."""
    from shazam_tpu.api import SIA
    from shazam_tpu.config import FingerprintConfig

    songs = _songs(6)

    def build(cfg):
        sia = SIA(device_span_rows=4096, config=cfg)
        for i in range(0, len(songs), 2):
            chunk = songs[i:i + 2]
            batch, nv = _pad_batch([s for _n, s in chunk])
            sia.ingest_device_batch([n for n, _s in chunk], batch, nv,
                                    per_song_hash_capacity=4096,
                                    defer_sort=True)
        sia._ensure_dev_store().consolidate()
        sia._host_stale = True
        return sia

    clip = songs[3][1][22050: 22050 + 2 * 44100]
    base = build(FingerprintConfig())
    probed = build(FingerprintConfig(bounds_probe_min_rows=1,
                                     expand_block_min_capacity=0))

    def strip(r):
        rs = r["results"][0]
        return (rs["song_name"], rs["offset"],
                rs["hashes_matched_in_input"], r["total_matches"])

    for fn in ("recognize_samples", "recognize_clip"):
        a = getattr(base, fn)(clip if fn == "recognize_clip" else [clip])
        b = getattr(probed, fn)(clip if fn == "recognize_clip" else [clip])
        assert strip(a) == strip(b), fn
        assert strip(a)[0] == "s3", fn
    ab = base.recognize_batch([clip, songs[0][1][:44100]])
    bb = probed.recognize_batch([clip, songs[0][1][:44100]])
    assert [strip(x) for x in ab] == [strip(x) for x in bb]


def test_spanned_decide_first_policy_matches_bounds():
    """Stacked spanned store on the big-index gate: the decided-first
    policy (one dispatch at the match_capacity tier, margin-certified)
    returns the same top-1 as the bounds-first policy, and forced
    escalation reuses the dispatch's own descent (exact either way)."""
    import dataclasses

    from shazam_tpu.api import SIA
    from shazam_tpu.config import FingerprintConfig

    cfg = FingerprintConfig(match_capacity=1024, match_capacity_fast=256,
                            match_capacity_max=1 << 16,
                            bounds_probe_min_rows=1,
                            sparse_vote_threshold=0)
    songs = _songs(6)
    sia = SIA(device_span_rows=4096, config=cfg)
    for i in range(0, len(songs), 2):
        chunk = songs[i:i + 2]
        batch, nv = _pad_batch([s for _n, s in chunk])
        sia.ingest_device_batch([n for n, _s in chunk], batch, nv,
                                per_song_hash_capacity=4096,
                                defer_sort=True)
    sia._ensure_dev_store().consolidate()

    for sid in (2, 5):
        clip = songs[sid][1][11025: 11025 + 3 * 44100]
        a = sia.recognize_samples([clip], topn=2)
        sia.config = dataclasses.replace(cfg, escalation_policy="bounds")
        b = sia.recognize_samples([clip], topn=2)
        sia.config = cfg
        assert a["results"][0]["song_name"] == f"s{sid}"
        assert a["results"][0]["song_name"] == b["results"][0]["song_name"]
        assert a["results"][0]["offset"] == b["results"][0]["offset"]

"""Edge cases: empty index, empty clips, topn > ranked songs."""

import numpy as np

from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_song


def test_recognize_on_empty_index():
    sia = SIA()
    clip = synth_song(0, duration_s=3.0, seed=1)
    out = sia.recognize_samples([clip])
    assert out["results"] == []
    assert out["total_matches"] == 0
    out2 = sia.recognize_clip(clip)
    assert out2["results"] == []


def test_recognize_silent_clip_against_catalog():
    sia = SIA()
    sia.ingest_arrays([("a", synth_song(0, duration_s=4.0, seed=2))])
    out = sia.recognize_samples([np.zeros(44100 * 3, np.int16)])
    assert out["results"] == []
    assert out["input_hashes"] == 0


def test_topn_exceeds_catalog():
    sia = SIA()
    sia.ingest_arrays([("only", synth_song(3, duration_s=4.0, seed=2))])
    clip = synth_song(3, duration_s=4.0, seed=2)[: 3 * 44100]
    out = sia.recognize_samples([clip], topn=5)
    assert len(out["results"]) == 1  # trimmed to ranked songs
    assert out["results"][0]["song_name"] == "only"


def test_batched_on_empty_index():
    sia = SIA()
    outs = sia.recognize_batch([synth_song(0, duration_s=3.0, seed=1)])
    assert outs[0]["results"] == []


def test_delete_songs_removes_from_catalog_and_index():
    sia = SIA()
    songs = [(f"s{i}", synth_song(i, duration_s=5.0, seed=66)) for i in range(3)]
    sia.ingest_arrays(songs)
    before = sia.index.n_hashes
    sid = [r["song_id"] for r in sia.catalog.get_songs()
           if r["song_name"] == "s1"][0]
    removed = sia.delete_songs([sid])
    assert removed > 0
    assert sia.index.n_hashes == before - removed
    assert sia.catalog.get_song_by_id(sid) is None
    out = sia.recognize_samples([songs[1][1][: 44100 * 4]])
    assert all(r["song_name"] != "s1" for r in out["results"])
    out0 = sia.recognize_samples([songs[0][1][: 44100 * 4]])
    assert out0["results"][0]["song_name"] == "s0"


def test_vote_key_overflow_guard():
    """n_songs * delta_range >= 2^31 must raise, not silently attribute
    votes to wrong songs (the packed int32 vote key would overflow)."""
    import jax.numpy as jnp
    import pytest
    from shazam_tpu.match.lookup import match_query, match_query_sparse

    z = jnp.zeros(4, jnp.uint32)
    dev = (z, z, z, z)
    for matcher in (match_query, match_query_sparse):
        with pytest.raises(ValueError, match="overflows"):
            matcher(dev, z, z, z, z, jnp.ones(4, bool), jnp.ones(4, bool),
                    n_songs=3, delta_min=0, delta_range=1 << 30,
                    match_capacity=64, offset_stride=4096)


def test_recognize_on_device_rejects_overlong_clip():
    """>2^16 frames would alias the packed (ex, t1) dedup key."""
    import jax.numpy as jnp
    import pytest
    from shazam_tpu.match.ondevice import recognize_on_device

    n = (70_000 + 1) * 2048 + 2048   # ~70K frames at hop 2048
    x = jnp.zeros((1, n), jnp.float32)
    z = jnp.zeros(4, jnp.uint32)
    with pytest.raises(ValueError, match="2\\^16"):
        recognize_on_device(
            x, jnp.asarray([n], jnp.int32), (z, z, z, z),
            n_songs=4, delta_min=-1024, delta_range=4096,
            offset_stride=4096)


def test_apriori_multibatch_total_not_flagged_overflow():
    """A multi-batch apriori match whose ACCUMULATED total exceeds one
    batch's match_capacity must not be reported as overflowed when no
    single batch clamped (votes were never dropped)."""
    import numpy as np
    from tests.test_match import (_index_from_rows, _query_from_pairs,
                                  _random_hex)
    from shazam_tpu.match.apriori import match_query_apriori

    rng = np.random.default_rng(51)
    # deterministic expansion: 200 unique hashes x exactly 2 rows each,
    # split across songs 2 and 3 so the 2x-leader margin never fires
    hexes = _random_hex(rng, 200)
    rows = [(h, 2 + r, 100 + 2 * i + r) for i, h in enumerate(hexes)
            for r in (0, 1)]
    index = _index_from_rows(rows)
    pairs = sorted({(h, 7) for h in hexes})
    q = _query_from_pairs(pairs)
    # each 32-pair batch expands exactly 64 rows < cap; total 400 > cap
    cap = 128
    raw, used, clamped = match_query_apriori(
        index.device_arrays(), q,
        n_songs=index.n_songs, delta_min=-(index.max_offset + 50),
        delta_range=2 * (index.max_offset + 50),
        match_capacity=cap, batch_size=32,
        offset_stride=index.offset_stride)
    assert used > 1
    assert int(raw.total_rows) == 400      # accumulated total exceeds cap
    assert not clamped                     # ...but nothing was dropped

    # shrink the cap below one batch's expansion: now it must flag
    _raw2, _u2, clamped2 = match_query_apriori(
        index.device_arrays(), q,
        n_songs=index.n_songs, delta_min=-(index.max_offset + 50),
        delta_range=2 * (index.max_offset + 50),
        match_capacity=32, batch_size=32,
        offset_stride=index.offset_stride)
    assert clamped2


def test_recognize_empty_channels_returns_no_match():
    """recognize_samples([]) (e.g. a stream queried before any audio)
    must return the reference's no-match shape, not crash."""
    from shazam_tpu.api import SIA

    sia = SIA()
    for arg in ([], [np.zeros(0, np.float32)]):
        out = sia.recognize_samples(arg)
        assert out["results"] == []
        assert out["total_matches"] == 0
        assert out["input_hashes"] == 0


def test_short_stream_window_raises():
    """Windows shorter than the ±radius context would garble _settle's
    slab slicing silently; both engines must refuse them loudly."""
    import pytest as _pytest

    from shazam_tpu.api import SIA
    from shazam_tpu.stream import IncrementalFingerprinter

    sia = SIA()
    with _pytest.raises(ValueError, match="radius"):
        IncrementalFingerprinter(sia.config, window_seconds=0.9)


def test_find_files_case_insensitive(tmp_path):
    from shazam_tpu.audio.io import find_files

    for name in ("a.wav", "B.WAV", "c.Wav", "d.mp3", "e.txt"):
        (tmp_path / name).write_bytes(b"x")
    got = sorted(p.rsplit("/", 1)[-1]
                 for p, _e in find_files(str(tmp_path), [".wav"]))
    assert got == ["B.WAV", "a.wav", "c.Wav"]

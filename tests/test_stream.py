"""Incremental streaming fingerprinting: equality with full recompute and
device work proportional to new audio (VERDICT round-1 item 5; reference
capture loop ``recognizer.py:355-382``)."""

import numpy as np
import pytest

from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_song
from shazam_tpu.stream import IncrementalFingerprinter, StreamRecognizer, CHUNK


@pytest.fixture(scope="module")
def engine():
    sia = SIA()
    songs = [
        (f"track{i}", synth_song(i, duration_s=20.0, seed=33 + i))
        for i in range(4)
    ]
    sia.ingest_arrays(songs)
    return sia


def _fingerprint_window(sia, samples):
    """Ground truth: from-scratch fingerprint of the window's samples."""
    from shazam_tpu.ops.fingerprint import (
        fingerprint_samples, fingerprint_to_hex_pairs,
    )
    import jax.numpy as jnp

    fp = fingerprint_samples(
        jnp.asarray(np.asarray(samples, np.float32)),
        fs=sia.config.sample_rate, peak_capacity=sia.config.peak_capacity,
    )
    return set(fingerprint_to_hex_pairs(fp))


def _hex_pairs(fp):
    from shazam_tpu.ops.fingerprint import fingerprint_to_hex_pairs

    return set(fingerprint_to_hex_pairs(fp))


def test_incremental_equals_full_recompute(engine):
    """After every feed, the incremental window hash set must equal a
    from-scratch fingerprint of exactly the window's sample range."""
    song = synth_song(1, duration_s=20.0, seed=34)
    inc = IncrementalFingerprinter(engine.config, window_seconds=6.0)

    stream = song.astype(np.float32)
    fed = 0
    checks = 0
    step = CHUNK
    while fed + step <= len(stream):
        inc.feed(stream[fed : fed + step])
        fed += step
        if fed < 3 * step or (fed // step) % 8:
            continue  # check a few window positions, incl. post-slide
        a, b = inc.window_sample_range()
        if b <= a:
            continue
        got = _hex_pairs(inc.fingerprints())
        ref = _fingerprint_window(engine, stream[a:b])
        assert got == ref, f"window [{a},{b}): {len(got)} vs {len(ref)}"
        checks += 1
    assert checks >= 3  # several positions verified, incl. slid windows


def test_incremental_work_proportional_to_new_audio(engine):
    """Per recognize: STFT columns computed == new frames only, and mask
    recompute is bounded by the two radius-wide edge strips."""
    song = synth_song(2, duration_s=20.0, seed=35).astype(np.float32)
    inc = IncrementalFingerprinter(engine.config, window_seconds=6.0)
    hop = engine.config.hop
    r = engine.config.peak_neighborhood_size

    # fill past one full window
    fed = 0
    while fed + CHUNK <= 15 * CHUNK:
        inc.feed(song[fed : fed + CHUNK])
        fed += CHUNK
    frames_before = inc.frames_computed
    strips_before = inc.strip_frames_computed

    inc.feed(song[fed : fed + CHUNK])
    inc.fingerprints()
    # exactly the new chunk's frames were STFT'd (no window recompute)
    assert inc.frames_computed - frames_before == CHUNK // hop
    # edge recompute bounded by two strips
    assert inc.strip_frames_computed - strips_before <= 2 * r


def test_stream_recognizer_incremental(engine):
    """End-to-end: chunked feed + incremental recognize() finds the song
    and equals the non-incremental (full recompute) result."""
    song = synth_song(3, duration_s=20.0, seed=36)
    clip = song[int(2.0 * 44100) : int(9.0 * 44100)]
    stereo = np.empty(2 * len(clip), np.int16)
    stereo[0::2] = clip
    stereo[1::2] = clip

    rec = StreamRecognizer(engine, channels=2, window_seconds=5.0)
    outs = []
    for base in range(0, len(stereo) - 2 * CHUNK, 2 * CHUNK):
        rec.feed(stereo[base : base + 2 * CHUNK])
        if rec.buffered_seconds > 4.0:
            outs.append(rec.recognize())
    assert len(outs) >= 3
    for out in outs:
        assert out["results"][0]["song_name"] == "track3"

    full = rec.recognize(incremental=False)
    inc = rec.recognize(incremental=True)
    assert inc["input_hashes"] == full["input_hashes"]
    assert (
        inc["results"][0]["hashes_matched_in_input"]
        == full["results"][0]["hashes_matched_in_input"]
    )
    assert inc["results"][0]["offset"] == full["results"][0]["offset"]


def test_stream_recognizer_spanned_store():
    """Streaming recognition against a spanned device store — the
    _match_prepared spanned path under the incremental fingerprinter."""
    sia = SIA(device_span_rows=4096)
    songs = [(f"track{i}", synth_song(i, duration_s=20.0, seed=33 + i))
             for i in range(3)]
    sia.ingest_arrays(songs)

    song = synth_song(2, duration_s=20.0, seed=35)
    clip = song[int(2.0 * 44100): int(9.0 * 44100)].astype(np.int16)
    rec = StreamRecognizer(sia, channels=1, window_seconds=5.0)
    out = None
    for base in range(0, len(clip) - CHUNK, CHUNK):
        rec.feed(clip[base: base + CHUNK])
        if rec.buffered_seconds > 4.0:
            out = rec.recognize()
    assert out is not None
    assert out["results"][0]["song_name"] == "track2"


def test_stream_recognizer_escalates_peak_capacity():
    """A dense window that overflows the configured peak capacity must
    escalate it (sticky) and STAY on the incremental path — previously
    every such recognize() silently fell back to a full-window
    recompute, permanently losing the incremental advantage."""
    from shazam_tpu.config import FingerprintConfig

    cfg = FingerprintConfig(peak_capacity=256, hash_capacity=1024)
    sia = SIA(config=cfg)
    song = synth_song(5, duration_s=20.0, seed=40)
    sia.ingest_arrays([("dense", song)])

    clip = song[int(2.0 * 44100): int(14.0 * 44100)].astype(np.int16)
    rec = StreamRecognizer(sia, channels=1, window_seconds=5.0)
    outs = []
    for base in range(0, len(clip) - CHUNK, CHUNK):
        rec.feed(clip[base: base + CHUNK])
        if rec.buffered_seconds > 4.5:
            outs.append(rec.recognize())
    assert len(outs) >= 2
    # a 5 s window of this song overflows 256 peaks -> capacity doubled
    assert rec._peak_cap > cfg.peak_capacity
    strips_before = rec._fps[0].strip_frames_computed
    out = rec.recognize()
    # still the incremental engine: the edge strips were recomputed
    assert rec._fps[0].strip_frames_computed > strips_before
    assert out["results"][0]["song_name"] == "dense"
    # and the escalated incremental result equals the full recompute
    full = rec.recognize(incremental=False)
    assert out["input_hashes"] == full["input_hashes"]
    assert (out["results"][0]["hashes_matched_in_input"]
            == full["results"][0]["hashes_matched_in_input"])


def test_incremental_buckets_device_shapes(engine):
    """Feeds of drifting chunk sizes must hit a BOUNDED set of device
    program shapes (each distinct slab length is a fresh XLA compile)
    while staying bit-identical to the
    from-scratch window fingerprint."""
    from shazam_tpu.ops import spectrogram as spec_mod
    from shazam_tpu.ops import peaks as peaks_mod

    spec_shapes, mask_shapes = set(), set()
    real_spec, real_mask = spec_mod.spectrogram_db, peaks_mod.peak_mask

    def spy_spec(samples, **kw):
        spec_shapes.add(int(samples.shape[0]))
        return real_spec(samples, **kw)

    def spy_mask(slab, *a, **kw):
        mask_shapes.add(int(slab.shape[1]))
        return real_mask(slab, *a, **kw)

    spec_mod.spectrogram_db = spy_spec
    peaks_mod.peak_mask = spy_mask
    try:
        inc = IncrementalFingerprinter(engine.config, window_seconds=6.0)
        song = synth_song(2, duration_s=18.0, seed=35).astype(np.float32)
        rng = np.random.default_rng(0)
        fed = 0
        while fed < len(song) - 3 * CHUNK:
            step = int(rng.integers(CHUNK // 2, 2 * CHUNK))  # drifting sizes
            inc.feed(song[fed: fed + step])
            fed += step
    finally:
        spec_mod.spectrogram_db = real_spec
        peaks_mod.peak_mask = real_mask

    wsize, hop = engine.config.window_size, engine.config.hop
    assert all(((n - wsize) // hop) + 1 in
               {1 << k for k in range(12)} for n in spec_shapes), spec_shapes
    assert all(w in {1 << k for k in range(12)} for w in mask_shapes), \
        mask_shapes
    # drifting chunks would otherwise produce ~a shape per feed
    assert len(spec_shapes) <= 4 and len(mask_shapes) <= 6, \
        (spec_shapes, mask_shapes)

    # and the cached state still equals the from-scratch ground truth
    a, b = inc.window_sample_range()
    assert _hex_pairs(inc.fingerprints()) == \
        _fingerprint_window(engine, song[a:b])


def test_peak_escalation_jumps_to_fitting_tier():
    """The overflow carries the true peak count, so one retry reaches a
    fitting tier — every intermediate tier would be a wasted
    compile."""
    from shazam_tpu.config import FingerprintConfig

    cfg = FingerprintConfig(peak_capacity=256, hash_capacity=1024)
    sia = SIA(config=cfg)
    song = synth_song(5, duration_s=20.0, seed=40)
    sia.ingest_arrays([("dense", song)])

    rec = StreamRecognizer(sia, channels=1, window_seconds=5.0)
    clip = song[int(2.0 * 44100): int(9.0 * 44100)].astype(np.int16)
    for base in range(0, len(clip) - CHUNK, CHUNK):
        rec.feed(clip[base: base + CHUNK])

    n = len(rec._fps[0].window_peaks()[0])
    assert n > 64  # precondition: the window overflows the forced tier
    rec._peak_cap = 64  # force an overflow on the next recognize

    calls = []
    real = rec._fps[0].fingerprints
    rec._fps[0].fingerprints = lambda **kw: calls.append(kw) or real(**kw)
    out = rec.recognize()
    assert out["results"][0]["song_name"] == "dense"
    # exactly one overflow retry: 64 -> fitting tier, no intermediates
    assert len(calls) == 2, calls
    assert calls[0]["capacity"] == 64
    assert rec._peak_cap >= n and rec._peak_cap // 2 < max(n, 65)

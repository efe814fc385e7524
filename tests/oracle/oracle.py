"""Golden oracle: CPU NumPy/scipy implementation with the exact semantics of
the reference pipeline (reference ``__init__.py:116-245`` and
``recognizer.py:222-338``).

This module is the plain reference the tests and ``chip_smoke.py`` compare
the device pipeline with. It freezes the behavior the pipeline must
reproduce: mlab.specgram numerics (re-derived in NumPy, so the oracle needs
no matplotlib), masked 10*log10, scipy maximum_filter
plateau behavior, the erosion-XOR background trick, (time, freq) peak
ordering, anchor/target pair enumeration, SHA-1 hex truncation, and the
groupby vote/rank of align_matches.
"""

from __future__ import annotations

import hashlib
from collections import defaultdict

import numpy as np
from scipy.ndimage import binary_erosion, maximum_filter


def mlab_psd_specgram(samples, fs=44100, wsize=4096, noverlap=2048):
    """``mlab.specgram(x, NFFT=wsize, Fs=fs, window=window_hanning,
    noverlap=noverlap)[0]`` in float64 NumPy, shape (n_freqs, n_frames).

    Frames of ``wsize`` samples every ``wsize - noverlap`` (no padding,
    except that a signal shorter than one window is zero-padded to it,
    as mlab does), symmetric Hann window (``np.hanning``), one-sided PSD
    with every bin but DC and Nyquist doubled, scaled by
    ``1 / (fs * sum(window**2))``.
    """
    x = np.asarray(samples, np.float64)
    if len(x) < wsize:
        x = np.concatenate([x, np.zeros(wsize - len(x))])
    step = wsize - noverlap
    n_frames = (len(x) - wsize) // step + 1
    win = np.hanning(wsize)
    idx = np.arange(n_frames)[:, None] * step + np.arange(wsize)[None, :]
    spec = np.abs(np.fft.rfft(x[idx] * win, axis=1)) ** 2
    spec[:, 1:(-1 if wsize % 2 == 0 else None)] *= 2.0
    spec /= fs * np.sum(win * win)
    return spec.T


def oracle_spectrogram(samples, fs=44100, wsize=4096, wratio=0.5):
    """dB power spectrogram, shape (n_freqs, n_frames).

    Matches reference ``fingerprint()`` up to the log transform
    (``__init__.py:232-241``): mlab.specgram PSD (Hann window, one-sided,
    scale_by_freq) then 10*log10 with exact zeros kept at 0.
    """
    spec = mlab_psd_specgram(samples, fs=fs, wsize=wsize,
                             noverlap=int(wsize * wratio))
    out = np.zeros_like(spec)
    np.log10(spec, out=out, where=(spec != 0))
    return 10.0 * out


def oracle_peaks(db_spec, amp_min=10, neighborhood=10):
    """Constellation peaks of a dB spectrogram as [(freq_idx, time_idx), ...].

    Matches reference ``get_2D_peaks`` (``__init__.py:116-177``): 21x21
    square footprint local maxima (maximum_filter, reflect boundary),
    XOR against the eroded zero-background (border_value=1), then a strict
    ``amp > amp_min`` filter. Returned in np.where order (freq-major).
    """
    size = 2 * neighborhood + 1
    footprint = np.ones((size, size), dtype=bool)
    is_max = maximum_filter(db_spec, footprint=footprint) == db_spec
    silent = binary_erosion(db_spec == 0, structure=footprint, border_value=1)
    mask = is_max != silent
    mask &= db_spec > amp_min
    f_idx, t_idx = np.nonzero(mask)
    return list(zip(f_idx, t_idx))


def oracle_hashes(peaks, fan_value=5, min_dt=0, max_dt=200, reduction=20):
    """Anchor/target pair hashes as [(hex20, t1), ...].

    Matches reference ``generate_hashes`` (``__init__.py:179-210``): peaks
    stable-sorted by time, anchor i paired with i+1..i+fan-1, keep
    min_dt <= dt <= max_dt, sha1 of "f1|f2|dt" truncated to `reduction`
    hex chars, emitted with the anchor's time offset.
    """
    ordered = sorted(peaks, key=lambda p: p[1])
    out = []
    n = len(ordered)
    for i in range(n):
        f1, t1 = ordered[i]
        for j in range(1, fan_value):
            if i + j >= n:
                continue
            f2, t2 = ordered[i + j]
            dt = t2 - t1
            if min_dt <= dt <= max_dt:
                msg = f"{f1}|{f2}|{dt}".encode("utf-8")
                out.append((hashlib.sha1(msg).hexdigest()[:reduction], int(t1)))
    return out


def oracle_fingerprint(samples, fs=44100, wsize=4096, wratio=0.5,
                       fan_value=5, amp_min=10, neighborhood=10,
                       min_dt=0, max_dt=200, reduction=20):
    """Full reference pipeline: samples -> [(hex20 hash, anchor frame)]."""
    spec = oracle_spectrogram(samples, fs=fs, wsize=wsize, wratio=wratio)
    peaks = oracle_peaks(spec, amp_min=amp_min, neighborhood=neighborhood)
    return oracle_hashes(peaks, fan_value=fan_value, min_dt=min_dt,
                         max_dt=max_dt, reduction=reduction)


def oracle_align(db_rows_by_hash, query_pairs, topn=2):
    """Vote/rank with reference semantics (``recognizer.py:222-338``).

    db_rows_by_hash: dict hex_hash -> list of (song_id, db_offset) rows.
    query_pairs: iterable of unique (hex_hash, sample_offset) pairs (the
        reference passes a set).

    Returns (ranked, dedup_counts) where ranked is a list of
    (song_id, best_delta, votes) sorted as the reference sorts, and
    dedup_counts maps song_id -> matched DB row count (one per row per
    distinct query hash; ``recognizer.py:259-269``).
    """
    mapper = defaultdict(list)
    for h, off in query_pairs:
        mapper[h.upper()].append(off)

    dedup_counts = defaultdict(int)
    votes = defaultdict(int)
    for h, offsets in mapper.items():
        for sid, db_off in db_rows_by_hash.get(h, ()):
            dedup_counts[sid] += 1
            for q_off in offsets:
                votes[(sid, db_off - q_off)] += 1

    # per song: the max-vote delta; ties -> smallest delta (groupby order)
    best = {}
    for (sid, delta), n in sorted(votes.items()):
        if sid not in best or n > best[sid][1]:
            best[sid] = (delta, n)
    ranked = sorted(
        ((sid, delta, n) for sid, (delta, n) in best.items()),
        key=lambda x: (-x[2], x[0]),
    )
    return ranked[:topn], dict(dedup_counts)

"""Golden parity: JAX DSP pipeline vs the NumPy/scipy oracle."""

import numpy as np
import pytest

from tests.oracle import (
    oracle_spectrogram,
    oracle_peaks,
    oracle_hashes,
    oracle_fingerprint,
)


def _jax_spec(samples):
    from shazam_tpu.ops.spectrogram import spectrogram_db

    return np.asarray(spectrogram_db(np.asarray(samples)))


def test_spectrogram_shape_and_values(short_clip):
    ours = _jax_spec(short_clip)
    ref = oracle_spectrogram(short_clip)
    assert ours.shape == ref.shape
    # f32 vs f64: dB values agree tightly away from the log singularity
    mask = ref > -80
    assert np.allclose(ours[mask], ref[mask], atol=0.15), (
        np.abs(ours[mask] - ref[mask]).max()
    )


def test_spectrogram_zero_input_stays_zero():
    silent = np.zeros(44100, np.int16)
    ours = _jax_spec(silent)
    assert np.all(ours == 0.0)


def test_peak_mask_matches_scipy(short_clip):
    from shazam_tpu.ops.peaks import peak_mask

    # evaluate both on the SAME spectrogram so only the filter semantics
    # are under test (peak identity vs fp noise is tested end-to-end below)
    ref_spec = oracle_spectrogram(short_clip).astype(np.float32)
    ours = np.asarray(peak_mask(ref_spec, 10.0, radius=10))
    ref = oracle_peaks(ref_spec.astype(np.float64), amp_min=10)
    ref_mask = np.zeros(ref_spec.shape, bool)
    for f, t in ref:
        ref_mask[f, t] = True
    assert np.array_equal(ours, ref_mask)


def test_peak_mask_silence_edges():
    """Silent stretches: erosion-XOR background must kill zero plateaus."""
    from shazam_tpu.ops.peaks import peak_mask

    spec = np.zeros((64, 50), np.float32)
    spec[30, 25] = 20.0  # one isolated peak in a sea of exact zeros
    ours = np.asarray(peak_mask(spec, 10.0, radius=10))
    ref = oracle_peaks(spec.astype(np.float64), amp_min=10)
    ref_mask = np.zeros(spec.shape, bool)
    for f, t in ref:
        ref_mask[f, t] = True
    assert np.array_equal(ours, ref_mask)


def test_extract_peaks_order_and_count(short_clip):
    from shazam_tpu.ops.peaks import extract_peaks

    ref_spec = oracle_spectrogram(short_clip).astype(np.float32)
    times, freqs, n_peaks = extract_peaks(ref_spec, 10.0, radius=10, capacity=8192)
    n = int(n_peaks)
    got = list(zip(np.asarray(times)[:n].tolist(), np.asarray(freqs)[:n].tolist()))
    ref = oracle_peaks(ref_spec.astype(np.float64), amp_min=10)
    # reference sorts by time with stable freq tie-break == (t, f) lex order
    ref_sorted = sorted(((t, f) for f, t in ref))
    assert n == len(ref)
    assert got == ref_sorted


def test_hashes_match_oracle_given_same_peaks(short_clip):
    from shazam_tpu.ops.peaks import extract_peaks
    from shazam_tpu.ops.hashes import generate_hashes
    from shazam_tpu.ops.sha1 import keys_to_hex
    import jax.numpy as jnp

    ref_spec = oracle_spectrogram(short_clip).astype(np.float32)
    times, freqs, n_peaks = extract_peaks(ref_spec, 10.0, radius=10, capacity=8192)
    hi, lo, ex, t1, valid = generate_hashes(times, freqs, jnp.uint32(int(n_peaks)))
    v = np.asarray(valid)
    ours = set(
        zip(
            keys_to_hex(np.asarray(hi)[v], np.asarray(lo)[v], np.asarray(ex)[v]),
            np.asarray(t1)[v].astype(int).tolist(),
        )
    )
    peaks = oracle_peaks(ref_spec.astype(np.float64), amp_min=10)
    ref = set(oracle_hashes(peaks))
    assert ours == ref


def test_fingerprint_end_to_end_parity(short_clip):
    """Full pipeline (f32) vs oracle (f64): hash sets must agree ~exactly.

    Peak identity can flip for values within fp noise of each other; gate
    on near-perfect Jaccard similarity rather than strict equality.
    """
    from shazam_tpu.ops.fingerprint import fingerprint, fingerprint_to_hex_pairs

    fp = fingerprint(np.asarray(short_clip))
    assert int(fp.n_peaks) <= 8192  # capacity not overflowed
    ours = set(fingerprint_to_hex_pairs(fp))
    ref = set(oracle_fingerprint(short_clip))
    inter = len(ours & ref)
    union = len(ours | ref)
    jaccard = inter / union
    assert jaccard > 0.98, f"jaccard={jaccard} ({len(ours)} vs {len(ref)})"


@pytest.mark.parametrize("signal", ["song", "short", "odd_length"])
def test_oracle_spectrogram_matches_mlab(signal):
    """The oracle's NumPy PSD is mlab.specgram's (the reference's call),
    including the zero-pad of a signal shorter than one window."""
    mlab = pytest.importorskip("matplotlib.mlab")
    from shazam_tpu.audio.synth import synth_song
    from tests.oracle.oracle import mlab_psd_specgram

    rng = np.random.default_rng(3)
    x = {"song": lambda: synth_song(3, duration_s=4.0, seed=1),
         "short": lambda: rng.normal(size=3000),
         "odd_length": lambda: rng.normal(size=4096 * 3 + 17)}[signal]()
    with np.errstate(all="ignore"):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = mlab.specgram(np.asarray(x), NFFT=4096, Fs=44100,
                                window=mlab.window_hanning,
                                noverlap=2048)[0]
    got = mlab_psd_specgram(x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12 * ref.max())

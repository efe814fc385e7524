"""The full fingerprint pipeline: samples -> 80-bit hash keys + offsets.

Replacement for reference ``fingerprint()`` (``__init__.py:212-245``):
spectrogram -> dB -> peak constellation -> fan-out pair hashing, one
jitted program with static shapes. Batched ingest vmaps this over a
leading song axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FingerprintConfig, DEFAULT_CONFIG
from .spectrogram import spectrogram_db
from .peaks import extract_peaks_from_mask, peak_mask
from .hashes import generate_hashes
from .sha1 import keys_to_hex


class Fingerprints(NamedTuple):
    """Fixed-capacity fingerprint set (device arrays, masked)."""

    hi: jnp.ndarray      # uint32 (H,)  sha1 bits 0..31
    lo: jnp.ndarray      # uint32 (H,)  sha1 bits 32..63
    ex: jnp.ndarray      # uint32 (H,)  sha1 bits 64..79
    t1: jnp.ndarray      # uint32 (H,)  anchor frame offset
    valid: jnp.ndarray   # bool   (H,)
    n_peaks: jnp.ndarray  # uint32 scalar — true peak count (overflow check)

    @property
    def n_hashes(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.uint32))


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "fan_value",
                     "min_dt", "max_dt", "peak_capacity"),
)
def fingerprint_samples(
    samples: jnp.ndarray,
    n_valid_samples: jnp.ndarray | None = None,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """Fingerprint one channel of samples (any float/int 1-D array).

    `n_valid_samples` supports pad-to-bucket batching: samples beyond it
    must be zeros; spectrogram columns whose frame extends past the valid
    length are zeroed so results are bit-identical to fingerprinting the
    unpadded signal (zero columns are background for the peak picker and
    can never pass the strict amp > amp_min gate).
    """
    if n_valid_samples is not None and amp_min <= 0:
        raise ValueError(
            "pad-to-bucket fingerprinting requires amp_min > 0: the "
            "zeroed pad columns rely on the strict amp > amp_min "
            "gate to stay peak-free (amp_min <= 0 would admit "
            "phantom peaks past the valid frames)")
    # one named scope per stage: profiler traces attribute device time
    # to them (benchmarks/profile_pipeline.py)
    with jax.named_scope("spectrogram"):
        spec = spectrogram_db(samples, fs=fs, wsize=wsize, hop=hop)
        if n_valid_samples is not None:
            n_valid_frames = jnp.maximum(
                (n_valid_samples.astype(jnp.int32) - wsize) // hop + 1, 0
            )
            col = jnp.arange(spec.shape[1], dtype=jnp.int32)[None, :]
            spec = jnp.where(col < n_valid_frames, spec, 0.0)
    with jax.named_scope("peaks"):
        mask = peak_mask(spec, amp_min, radius=radius)
    with jax.named_scope("compaction"):
        times, freqs, n_peaks = extract_peaks_from_mask(
            mask, capacity=peak_capacity)
    with jax.named_scope("sha1"):
        hi, lo, ex, t1, valid = generate_hashes(
            times, freqs, jnp.minimum(n_peaks, jnp.uint32(peak_capacity)),
            fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        )
    return Fingerprints(hi, lo, ex, t1, valid, n_peaks)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "fan_value",
                     "min_dt", "max_dt", "peak_capacity"),
)
def fingerprint_batch(
    samples: jnp.ndarray,
    n_valid_samples: jnp.ndarray,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """vmapped fingerprint over a (batch, padded_len) song matrix.

    The device analog of the reference's multiprocessing ingest pool
    (``__init__.py:335-357``): data parallelism over songs becomes one
    batched device program. Every ingest and query path fingerprints
    through this entry point (or its single-song body).
    """
    fn = functools.partial(
        fingerprint_samples,
        fs=fs, wsize=wsize, hop=hop, amp_min=amp_min, radius=radius,
        fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
    )
    return jax.vmap(fn)(samples, n_valid_samples)


def fingerprint(samples, config: FingerprintConfig = DEFAULT_CONFIG,
                peak_capacity: int | None = None) -> Fingerprints:
    """Config-driven wrapper around ``fingerprint_samples``."""
    cap = peak_capacity or config.peak_capacity
    return fingerprint_samples(
        jnp.asarray(samples),
        fs=config.sample_rate,
        wsize=config.window_size,
        hop=config.hop,
        amp_min=config.amp_min,
        radius=config.peak_neighborhood_size,
        fan_value=config.fan_value,
        min_dt=config.min_hash_time_delta,
        max_dt=config.max_hash_time_delta,
        peak_capacity=cap,
    )


def fingerprints_to_pairs(fp: Fingerprints, dedup: bool = True):
    """Host-side: materialize (hex20, t1) pairs like the reference returns.

    With dedup=True the result is the set the reference builds at
    ``recognizer.py:378-382`` (unique (hash, offset) pairs), as parallel
    numpy arrays sorted by key then offset.
    """
    valid = np.asarray(fp.valid)
    hi = np.asarray(fp.hi)[valid]
    lo = np.asarray(fp.lo)[valid]
    ex = np.asarray(fp.ex)[valid]
    t1 = np.asarray(fp.t1)[valid]
    if dedup and hi.size:
        stacked = np.stack(
            [hi.astype(np.uint64), lo.astype(np.uint64),
             ex.astype(np.uint64), t1.astype(np.uint64)], axis=1
        )
        stacked = np.unique(stacked, axis=0)
        hi, lo, ex, t1 = (stacked[:, i].astype(np.uint32) for i in range(4))
    return hi, lo, ex, t1


def fingerprint_to_hex_pairs(fp: Fingerprints, dedup: bool = True):
    """[(hex20, offset)] pairs for parity tests against the oracle."""
    hi, lo, ex, t1 = fingerprints_to_pairs(fp, dedup=dedup)
    return list(zip(keys_to_hex(hi, lo, ex), t1.astype(int).tolist()))

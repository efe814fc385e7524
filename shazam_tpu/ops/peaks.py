"""Constellation peak picking: 2-D local maxima with fixed-capacity output.

Matches reference ``get_2D_peaks`` (``__init__.py:116-177``):

- local maxima under a (2n+1)x(2n+1) full-square footprint
  (``iterate_structure(generate_binary_structure(2, 2), n)``) using
  scipy ``maximum_filter`` plateau semantics (every element equal to the
  window max is marked),
- XOR against the binary-eroded zero background (border_value=1) to kill
  the all-zero silence plateau,
- strict ``amp > amp_min`` threshold.

Design:
- The square footprint makes both the max filter and the erosion
  *separable*: two 1-D ``reduce_window`` passes (freq axis then time
  axis) instead of a 441-tap 2-D window. XLA lowers these to fused
  sliding reductions.
- scipy's default 'reflect' boundary duplicates in-window values only
  (a reflected cell at distance d < n from the edge maps back inside the
  window), so padding with -inf / True is exactly equivalent.
- Dynamic peak counts become a fixed capacity: peaks are compacted in
  (time, freq) row-major order — precisely the reference's
  ``peaks.sort(key=time)`` order incl. tie-breaks, since np.where yields
  freq-major order and Python's sort is stable — via one ``top_k`` over
  flat indices. Overflow is reported, never silent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_NEG_INF = np.float32(-np.inf)


def _separable_window(x: jnp.ndarray, radius: int, op, init) -> jnp.ndarray:
    """Apply a (2r+1)x(2r+1) square sliding `op` with `init` padding."""
    r = radius
    y = lax.reduce_window(
        x, init, op, window_dimensions=(2 * r + 1, 1),
        window_strides=(1, 1), padding=((r, r), (0, 0)),
    )
    return lax.reduce_window(
        y, init, op, window_dimensions=(1, 2 * r + 1),
        window_strides=(1, 1), padding=((0, 0), (r, r)),
    )


def local_max_mask(db_spec: jnp.ndarray, radius: int) -> jnp.ndarray:
    """maximum_filter(footprint=square) == arr, scipy plateau semantics."""
    filt = _separable_window(db_spec, radius, lax.max, _NEG_INF)
    return filt == db_spec


def eroded_background_mask(db_spec: jnp.ndarray, radius: int) -> jnp.ndarray:
    """binary_erosion(arr == 0, square structure, border_value=1)."""
    background = db_spec == 0
    return _separable_window(background, radius, jnp.logical_and, True)


@functools.partial(jax.jit, static_argnames=("radius",))
def peak_mask(db_spec: jnp.ndarray, amp_min: float, radius: int = 10) -> jnp.ndarray:
    """Boolean (n_freqs, n_frames) constellation mask."""
    detected = local_max_mask(db_spec, radius) != eroded_background_mask(db_spec, radius)
    return detected & (db_spec > amp_min)


@functools.partial(jax.jit, static_argnames=("radius", "capacity", "frame_capacity"))
def extract_peaks(db_spec: jnp.ndarray, amp_min: float,
                  radius: int = 10, capacity: int = 8192,
                  frame_capacity: int = 128):
    """Compact the peak mask into fixed-size (time, freq) index arrays.

    Returns (times, freqs, n_peaks): uint32 arrays of shape (capacity,) in
    (time, freq)-lexicographic order — the reference's hash-pairing order —
    and the true peak count (may exceed capacity; callers must check).
    Slots >= min(n_peaks, capacity) are filled with zeros and must be
    masked by the caller.

    Two-level compaction: a flat top_k over the whole F x T mask is far
    costlier than the rest of the pipeline, so we first compact each
    STFT frame to `frame_capacity` candidates with a per-row top_k
    over the 2049 freq bins, then run the global order-preserving top_k
    over only n_frames * frame_capacity candidates. If any frame holds
    more than `frame_capacity` peaks (a near-constant plateau — degenerate
    input), n_peaks is clamped above `capacity` so callers see overflow.
    """
    return extract_peaks_from_mask(
        peak_mask(db_spec, amp_min, radius),
        capacity=capacity, frame_capacity=frame_capacity,
    )


@functools.partial(jax.jit, static_argnames=("capacity", "frame_capacity"))
def extract_peaks_from_mask(mask: jnp.ndarray, capacity: int = 8192,
                            frame_capacity: int = 128):
    """``extract_peaks`` from an already-computed (n_freqs, n_frames)
    constellation mask (the incremental streaming engine composes its
    window mask from settled ring columns + recomputed edge strips)."""
    n_freqs, n_frames = mask.shape
    mask_t = mask.T  # (T, F): row-major == (t, f) lex order
    n = n_freqs * n_frames
    frame_counts = jnp.sum(mask_t.astype(jnp.int32), axis=1)
    n_peaks = jnp.sum(frame_counts).astype(jnp.uint32)

    # level 1: per-frame compaction (score = F - f: descending top_k
    # values give ascending freq order; 0 marks empty lanes)
    f_iota = jnp.arange(n_freqs, dtype=jnp.int32)[None, :]
    frame_score = jnp.where(mask_t, n_freqs - f_iota, 0)
    fvals, _ = lax.top_k(frame_score, min(frame_capacity, n_freqs))
    cand_valid = fvals > 0
    cand_f = jnp.where(cand_valid, n_freqs - fvals, 0)

    # level 2: global order-preserving compaction over T * frame_capacity
    t_iota = jnp.arange(n_frames, dtype=jnp.int32)[:, None]
    flat_idx = t_iota * n_freqs + cand_f
    score = jnp.where(cand_valid, n - flat_idx, 0).reshape(-1)
    m = score.shape[0]
    vals, _ = lax.top_k(score, min(capacity, m))
    if capacity > m:
        vals = jnp.pad(vals, (0, capacity - m))
    valid = vals > 0
    out_idx = jnp.where(valid, n - vals, 0).astype(jnp.uint32)
    times = out_idx // jnp.uint32(n_freqs)
    freqs = out_idx % jnp.uint32(n_freqs)

    # degenerate plateaus: frame overflow must surface as capacity overflow
    frame_overflow = jnp.any(frame_counts > frame_capacity)
    n_peaks = jnp.where(
        frame_overflow, jnp.maximum(n_peaks, jnp.uint32(capacity + 1)), n_peaks
    )
    return times, freqs, n_peaks

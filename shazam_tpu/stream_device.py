"""Device-resident incremental stream fingerprinting (fixed-shape rings).

``stream.IncrementalFingerprinter`` keeps its spectrogram/mask column
caches on the host and device_gets every new column — fine for 15 s
windows, but each ``feed``/``recognize`` round-trips columns and runs
variable-shape programs (a fresh XLA compile per distinct chunk size).
This engine is the fixed-shape device version:

- state is two HBM ring buffers, (ring_frames, n_freqs) spectrogram dB
  and settled peak-mask rows; the host holds only scalar counters and a
  sample residual;
- audio is consumed in fixed 16-frame quanta, so ``feed`` runs ONE
  compiled program per quantum (STFT of a fixed 34816-sample block +
  two aligned dynamic-update-slices + the settle of an earlier
  16-frame block with its full ±radius context gathered from the ring);
- ``recognize`` is ONE compiled program: gather the window rows, settle
  parity holds for the interior, recompute only the window-clipped edge
  strips, compact peaks and hash — all on device.

Results are identical to fingerprinting the window from scratch
(tests/test_stream_device.py): settled interior columns saw their full
±radius context, and zero-filled pre-stream rows are exact because the
amp_min > 0 gate makes zero background indistinguishable from the
boundary clipping of a full pass (the same argument that lets batch
ingest zero its padded columns). Reference behavior matched: the capture loop at
``recognizer.py:355-382`` refingerprints its whole window every pass;
here device work per call is proportional to NEW audio.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import numpy as np

from .config import FingerprintConfig
from .ops.fingerprint import Fingerprints

FRAME_STEP = 16          # frames per feed quantum (aligned ring writes)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "cap"),
)
def _ring_step(block, spec_ring, mask_ring, t_new, *, fs, wsize, hop,
               amp_min, radius, cap):
    """Absorb frames [t_new - 16, t_new): STFT write + lagged settle.

    The settle covers frames [t_new - 32, t_new - 16) — 16-aligned, so
    both dynamic-update-slices are aligned and never wrap (cap % 16 == 0,
    and a row's slot is overwritten only cap frames later).
    """
    import jax.numpy as jnp
    from jax import lax

    from .ops.peaks import peak_mask
    from .ops.spectrogram import spectrogram_db

    cols = spectrogram_db(block, fs=fs, wsize=wsize, hop=hop)  # (F, 16)
    w_pos = lax.rem(t_new - FRAME_STEP, cap)
    spec_ring = lax.dynamic_update_slice(spec_ring, cols.T, (w_pos, 0))

    s0 = t_new - 2 * FRAME_STEP
    idx = s0 - radius + jnp.arange(FRAME_STEP + 2 * radius, dtype=jnp.int32)
    rows = jnp.take(spec_ring, jnp.remainder(idx, cap), axis=0)
    rows = jnp.where((idx >= 0)[:, None], rows, 0.0)  # pre-stream rows
    m = peak_mask(rows.T, amp_min, radius)            # (F, 16 + 2r)
    block_mask = m[:, radius: radius + FRAME_STEP].T  # (16, F)

    def write(mr):
        return lax.dynamic_update_slice(mr, block_mask, (lax.rem(s0, cap), 0))

    mask_ring = lax.cond(s0 >= 0, write, lambda mr: mr, mask_ring)
    return spec_ring, mask_ring


@functools.partial(
    jax.jit,
    static_argnames=("window_frames", "cap", "amp_min", "radius",
                     "capacity", "frame_capacity", "fan_value", "min_dt",
                     "max_dt"),
)
def _ring_fingerprint(spec_ring, mask_ring, t, *, window_frames, cap,
                      amp_min, radius, capacity, frame_capacity,
                      fan_value, min_dt, max_dt):
    """Fingerprint the window [t - window_frames, t) from the rings."""
    import jax.numpy as jnp

    from .ops.hashes import generate_hashes
    from .ops.peaks import extract_peaks_from_mask, peak_mask

    w = window_frames
    idx = jnp.remainder(t - w + jnp.arange(w, dtype=jnp.int32), cap)
    spec_win = jnp.take(spec_ring, idx, axis=0)       # (W, F)
    mask_win = jnp.take(mask_ring, idx, axis=0)

    r = radius
    tail = FRAME_STEP + r  # unsettled head frames + right-clip context
    # left strip [w0, w0 + r): full pass clips its context at the window
    left = peak_mask(spec_win[: 2 * r].T, amp_min, r)[:, :r].T
    # right strip [t - 16, t): unsettled; slab gives full left context,
    # window clipping on the right falls out of the slab ending at t
    right = peak_mask(spec_win[-(tail + r):].T, amp_min, r)[:, r:].T
    mask = jnp.concatenate([left, mask_win[r: w - tail], right], axis=0)

    times, freqs, n_peaks = extract_peaks_from_mask(
        mask.T, capacity=capacity, frame_capacity=frame_capacity
    )
    hi, lo, ex, t1, valid = generate_hashes(
        times, freqs, n_peaks.astype(jnp.uint32),
        fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
    )
    # a single STFT column past frame_capacity is NOT fixable by raising
    # the total peak capacity — surface it separately so the caller
    # falls back instead of burning escalation recompiles
    frame_over = jnp.any(
        jnp.sum(mask, axis=1, dtype=jnp.int32) > frame_capacity
    )
    return Fingerprints(hi, lo, ex, t1, valid, n_peaks), frame_over


class DeviceIncrementalFingerprinter:
    """Drop-in sibling of ``stream.IncrementalFingerprinter`` whose column
    caches live in HBM and whose per-call programs have fixed shapes."""

    def __init__(self, config: FingerprintConfig, window_seconds: float):
        import jax.numpy as jnp

        self.config = config
        wsize, hop = config.window_size, config.hop
        if config.peak_neighborhood_size > FRAME_STEP:
            raise ValueError("device streaming requires radius <= 16")
        self.n_freqs = wsize // 2 + 1
        self.window_frames = max(
            (int(window_seconds * config.sample_rate) - wsize) // hop + 1, 1
        )
        if self.window_frames < 3 * FRAME_STEP:
            raise ValueError(
                "device streaming needs a >= ~2.5 s window; use the host "
                "IncrementalFingerprinter for shorter ones"
            )
        self.radius = config.peak_neighborhood_size
        self.cap = _round_up(self.window_frames, FRAME_STEP) + 4 * FRAME_STEP
        self._block = (FRAME_STEP - 1) * hop + wsize   # samples per quantum
        self._spec_ring = jnp.zeros((self.cap, self.n_freqs), jnp.float32)
        self._mask_ring = jnp.zeros((self.cap, self.n_freqs), bool)
        self._residual = np.zeros(0, np.float32)
        self._t = 0                      # absolute frames absorbed
        self.frames_computed = 0         # lifetime STFT columns (stats)

    # ---- the stream.IncrementalFingerprinter surface ------------------
    @property
    def n_frames(self) -> int:
        return self._t

    @property
    def window_bounds(self) -> Tuple[int, int]:
        return max(0, self._t - self.window_frames), self._t

    def window_sample_range(self) -> Tuple[int, int]:
        w0, w1 = self.window_bounds
        wsize, hop = self.config.window_size, self.config.hop
        return w0 * hop, (w1 - 1) * hop + wsize if w1 > w0 else w0 * hop

    @property
    def ready(self) -> bool:
        """True once the ring holds one full, settle-covered window."""
        return self._t >= max(self.window_frames, 2 * FRAME_STEP)

    def feed(self, samples: np.ndarray) -> None:
        import jax.numpy as jnp

        hop = self.config.hop
        data = np.concatenate(
            [self._residual, np.asarray(samples, np.float32)]
        )
        while len(data) >= self._block:
            self._t += FRAME_STEP
            self._spec_ring, self._mask_ring = _ring_step(
                jnp.asarray(data[: self._block]),
                self._spec_ring, self._mask_ring, self._t,
                fs=self.config.sample_rate, wsize=self.config.window_size,
                hop=hop, amp_min=self.config.amp_min, radius=self.radius,
                cap=self.cap,
            )
            self.frames_computed += FRAME_STEP
            data = data[FRAME_STEP * hop:]
        self._residual = data

    def fingerprints(self, capacity: Optional[int] = None) -> Fingerprints:
        import jax

        if not self.ready:
            raise OverflowError(
                "ring window not full yet; use the fallback recompute"
            )
        cap = capacity or self.config.peak_capacity
        fp, frame_over = jax.device_get(_ring_fingerprint(
            self._spec_ring, self._mask_ring, self._t,
            window_frames=self.window_frames, cap=self.cap,
            amp_min=self.config.amp_min, radius=self.radius,
            capacity=cap, frame_capacity=128,
            fan_value=self.config.fan_value,
            min_dt=self.config.min_hash_time_delta,
            max_dt=self.config.max_hash_time_delta,
        ))
        if bool(frame_over):
            err = OverflowError(
                "an STFT column holds > 128 peaks; raising the total "
                "peak capacity cannot fix a per-frame overflow — use "
                "the full-recompute fallback"
            )
            err.escalate = False  # caller must NOT retry at 2x capacity
            raise err
        if int(fp.n_peaks) > cap:
            err = OverflowError(
                f"window holds {int(fp.n_peaks)} peaks > capacity {cap}"
            )
            err.n_peaks = int(fp.n_peaks)  # caller jumps to a fitting tier
            raise err
        return fp

    def reset(self) -> None:
        import jax.numpy as jnp

        self._spec_ring = jnp.zeros((self.cap, self.n_freqs), jnp.float32)
        self._mask_ring = jnp.zeros((self.cap, self.n_freqs), bool)
        self._residual = np.zeros(0, np.float32)
        self._t = 0

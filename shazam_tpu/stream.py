"""Streaming recognition: incremental fingerprinting + optional mic capture.

The reference records CHUNK=8192-sample pyaudio buffers into channel
lists and fingerprints the WHOLE window after RECORD_SECONDS
(``recognizer.py:355-382``). A continuous-listening deployment calling
``recognize()`` repeatedly would redo ~15 s of STFT per call, so here the
per-channel fingerprint state is incremental:

- spectrogram columns are computed once per frame as samples arrive
  (device work per ``recognize()`` is proportional to NEW audio);
- constellation-peak mask columns "settle" once their full ±radius frame
  context exists and are cached; only two radius-wide strips at the
  current window's edges are recomputed per call (the window boundary
  clips the peak neighborhood there, exactly like a full recompute);
- hash pairing + the index match run on the window's peak set (cheap).

Results are identical to fingerprinting the window's samples from
scratch (tests/test_stream.py asserts bit-equality of the hash sets).

Mic capture itself stays host-side and optional: ``mic_chunks`` yields
chunks via pyaudio when (and only when) that package exists — CI and
benches use the file path (SURVEY.md §4/§7: the mic cannot be the
correctness oracle).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .api import SIA
from .config import FingerprintConfig
from .ops.fingerprint import Fingerprints

CHUNK = 8192  # samples per chunk per channel (recognizer.py:25)


class IncrementalFingerprinter:
    """Per-channel incremental fingerprint state over a sliding window.

    Absolute frame t covers stream samples [t*hop, t*hop + wsize); the
    recognition window is the last ``window_frames`` computed frames
    (its start is always hop-aligned, so window frames coincide with
    stream frames and cached columns stay valid as the window slides).
    """

    def __init__(self, config: FingerprintConfig, window_seconds: float):
        self.config = config
        wsize, hop = config.window_size, config.hop
        self.n_freqs = wsize // 2 + 1
        self.window_frames = max(
            (int(window_seconds * config.sample_rate) - wsize) // hop + 1, 1
        )
        self.radius = config.peak_neighborhood_size
        if self.window_frames < 2 * self.radius:
            # _settle's slab slicing assumes the window retains at least
            # the ±radius context of every settled frame; shorter windows
            # would slice negative and garble the mask silently (the
            # device engine raises the same way)
            raise ValueError(
                f"window_seconds={window_seconds} gives "
                f"{self.window_frames} frames < 2 * radius "
                f"({2 * self.radius}); use a window of at least "
                f"{(2 * self.radius * hop + wsize) / config.sample_rate:.2f} s"
            )
        self._residual = np.zeros(0, np.float32)   # unframed sample tail
        self._spec = np.zeros((self.n_freqs, 0), np.float32)
        self._mask = np.zeros((self.n_freqs, 0), bool)  # settled columns
        self._base = 0          # absolute frame index of _spec[:, 0]
        self._settled = 0       # absolute frames with settled peak mask
        self.frames_computed = 0   # lifetime STFT columns (stats/tests)
        self.strip_frames_computed = 0  # edge-strip mask columns (stats)

    @property
    def n_frames(self) -> int:
        """Absolute frames computed so far (= window end W1)."""
        return self._base + self._spec.shape[1]

    @property
    def window_bounds(self) -> Tuple[int, int]:
        """[W0, W1) absolute frame range of the current window."""
        w1 = self.n_frames
        return max(0, w1 - self.window_frames), w1

    def feed(self, samples: np.ndarray) -> None:
        """Append mono samples; compute spectrogram columns for every
        newly completed frame (the only per-sample device work).

        The sample slab is zero-padded to a power-of-two FRAME count
        before the device call: every distinct slab length is a distinct
        XLA program, and feed chunk
        sizes drift with the residual, so unbucketed shapes compile
        per-call. Frames are per-sample-window independent and the tail
        frames past n_new (whose windows mix real samples with padding)
        are sliced off — the KEPT columns read only real samples, so
        they are bit-identical to the unpadded computation."""
        import jax
        from .ops.spectrogram import spectrogram_db

        wsize, hop = self.config.window_size, self.config.hop
        data = np.concatenate([
            self._residual, np.asarray(samples, np.float32)
        ])
        if len(data) < wsize:
            self._residual = data
            return
        n_new = (len(data) - wsize) // hop + 1
        n_pad = 1 << (n_new - 1).bit_length() if n_new > 1 else 1
        buf = np.zeros((n_pad - 1) * hop + wsize, np.float32)
        buf[: (n_new - 1) * hop + wsize] = data[: (n_new - 1) * hop + wsize]
        cols = np.asarray(jax.device_get(spectrogram_db(
            buf, fs=self.config.sample_rate, wsize=wsize, hop=hop,
        )))[:, :n_new]
        self._residual = data[n_new * hop :]
        self._spec = np.concatenate([self._spec, cols], axis=1)
        self.frames_computed += n_new
        self._settle()
        self._evict()

    def _settle(self) -> None:
        """Extend the cached peak mask to every frame whose full ±radius
        context exists. Interior columns of any slab equal the full
        computation (the separable max pads with -inf outside the slab,
        so columns >= radius from the slab edge see only real data)."""
        import jax
        from .ops.peaks import peak_mask

        r = self.radius
        new_until = max(self.n_frames - r, 0)
        if new_until <= self._settled:
            return
        a = self._settled            # absolute col range to settle: [a, b)
        b = new_until
        slab_lo = max(a - r, 0)
        slab = self._spec[:, slab_lo - self._base : b + r - self._base]
        # pad the slab to a power-of-two width so drifting settle spans
        # don't compile a fresh peak_mask program per call (see feed);
        # pad columns sit > radius from every kept column, and 0.0 is
        # exactly what the dB spectrogram emits for silence
        width = slab.shape[1]
        w_pad = 1 << (width - 1).bit_length() if width > 1 else 1
        if w_pad > width:
            slab = np.concatenate(
                [slab, np.zeros((self.n_freqs, w_pad - width), np.float32)],
                axis=1)
        m = np.asarray(jax.device_get(peak_mask(
            slab, self.config.amp_min, radius=r,
        )))
        keep = m[:, a - slab_lo : b - slab_lo]
        # columns < radius from the stream start have true (clipped)
        # context: the slab starts at frame 0 exactly like a full pass
        grow = b - (self._base + self._mask.shape[1])
        if grow > 0:
            self._mask = np.concatenate(
                [self._mask, np.zeros((self.n_freqs, grow), bool)], axis=1
            )
        self._mask[:, a - self._base : b - self._base] = keep
        self._settled = b

    def _evict(self) -> None:
        """Drop cached columns older than the current window start."""
        w0, _ = self.window_bounds
        drop = w0 - self._base
        if drop > 0:
            self._spec = self._spec[:, drop:]
            self._mask = self._mask[:, drop:]
            self._base = w0

    def _edge_strip(self, lo: int, hi: int, window: Tuple[int, int]) -> np.ndarray:
        """Peak-mask columns [lo, hi) computed with the WINDOW's boundary
        clipping (exactly what a from-scratch pass over the window sees)."""
        import jax
        from .ops.peaks import peak_mask

        r = self.radius
        w0, w1 = window
        slab_lo = max(lo - r, w0)
        slab_hi = min(hi + r, w1)
        slab = self._spec[:, slab_lo - self._base : slab_hi - self._base]
        m = np.asarray(jax.device_get(peak_mask(
            slab, self.config.amp_min, radius=r,
        )))
        self.strip_frames_computed += hi - lo
        return m[:, lo - slab_lo : hi - slab_lo]

    def window_peaks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(times, freqs) of the current window's peaks, window-relative,
        in (t, f) order — identical to extract_peaks on the window."""
        w0, w1 = self.window_bounds
        if w1 <= w0:
            return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
        r = self.radius
        if w1 - w0 <= 2 * r:
            mask = self._edge_strip(w0, w1, (w0, w1))
        else:
            left = self._edge_strip(w0, w0 + r, (w0, w1))
            right = self._edge_strip(w1 - r, w1, (w0, w1))
            interior = self._mask[:, w0 + r - self._base : w1 - r - self._base]
            mask = np.concatenate([left, interior, right], axis=1)
        t_idx, f_idx = np.nonzero(mask.T)   # (t, f) lex order
        return t_idx.astype(np.uint32), f_idx.astype(np.uint32)

    def fingerprints(self, capacity: Optional[int] = None) -> Fingerprints:
        """Hash the window's peaks (pairing + SHA-1 on device)."""
        import jax
        import jax.numpy as jnp
        from .ops.hashes import generate_hashes

        times, freqs = self.window_peaks()
        cap = capacity or self.config.peak_capacity
        n = len(times)
        if n > cap:
            err = OverflowError(
                f"window holds {n} peaks > capacity {cap}; raise peak_capacity"
            )
            err.n_peaks = n   # lets the caller jump straight to a fitting tier
            raise err
        t_pad = np.zeros(cap, np.uint32)
        f_pad = np.zeros(cap, np.uint32)
        t_pad[:n] = times
        f_pad[:n] = freqs
        hi, lo, ex, t1, valid = generate_hashes(
            jnp.asarray(t_pad), jnp.asarray(f_pad), jnp.uint32(n),
            fan_value=self.config.fan_value,
            min_dt=self.config.min_hash_time_delta,
            max_dt=self.config.max_hash_time_delta,
        )
        return Fingerprints(*jax.device_get((hi, lo, ex, t1, valid)),
                            np.uint32(n))

    def window_sample_range(self) -> Tuple[int, int]:
        """[start, end) absolute sample range a full recompute of this
        window would fingerprint (for parity tests / fallbacks)."""
        w0, w1 = self.window_bounds
        wsize, hop = self.config.window_size, self.config.hop
        return w0 * hop, (w1 - 1) * hop + wsize if w1 > w0 else w0 * hop

    def reset(self) -> None:
        self._residual = np.zeros(0, np.float32)
        self._spec = np.zeros((self.n_freqs, 0), np.float32)
        self._mask = np.zeros((self.n_freqs, 0), bool)
        self._base = 0
        self._settled = 0


class StreamRecognizer:
    """Rolling window of interleaved audio chunks + incremental recognition.

    ``feed()`` consumes interleaved int16 chunks from any producer
    (microphone, socket, file reader); ``recognize()`` matches the current
    window. Fingerprint state is incremental per channel; a raw sample
    ring is kept only as the overflow fallback and for parity tests.
    """

    def __init__(self, sia: SIA, channels: int = 2,
                 window_seconds: float = 15.0, engine: str = "host"):
        """engine="device" keeps the incremental state in HBM ring
        buffers with fixed-shape per-chunk programs (stream_device.py);
        "host" caches columns host-side (identical results either way).
        """
        self.sia = sia
        self.channels = channels
        self.window_seconds = window_seconds
        self.window_samples = int(window_seconds * sia.config.sample_rate)
        if engine == "device":
            from .stream_device import DeviceIncrementalFingerprinter

            fp_cls = DeviceIncrementalFingerprinter
        elif engine == "host":
            fp_cls = IncrementalFingerprinter
        else:
            raise ValueError(f"unknown streaming engine {engine!r}")
        self._fps = [
            fp_cls(sia.config, window_seconds) for _ in range(channels)
        ]
        self._rings: List[np.ndarray] = [
            np.zeros(0, np.int16) for _ in range(channels)
        ]
        self._ring_start = 0   # absolute sample index of ring[0]
        # per-window peak capacity; doubles when dense audio overflows it
        # (sticky, so one escalation covers the rest of the stream and
        # the incremental path is never permanently lost to the full-
        # recompute fallback). Same 1<<22 bound as SIA's query path.
        self._peak_cap = sia.config.peak_capacity

    def feed(self, chunk: np.ndarray) -> None:
        """Consume one interleaved int16 chunk (len = n * channels)."""
        chunk = np.asarray(chunk, np.int16)
        for c in range(self.channels):
            ch = chunk[c :: self.channels]
            self._fps[c].feed(ch)
            self._rings[c] = np.concatenate([self._rings[c], ch])
        # slack covers the fingerprinter's residual: the device engine
        # consumes 16-frame quanta, so up to ~15 hops + a window of
        # samples can be fed but not yet absorbed into frames
        keep = (self.window_samples + 2 * self.sia.config.window_size
                + 16 * self.sia.config.hop)
        if len(self._rings[0]) > keep:
            drop = len(self._rings[0]) - keep
            self._rings = [r[drop:] for r in self._rings]
            self._ring_start += drop

    @property
    def buffered_seconds(self) -> float:
        return len(self._rings[0]) / self.sia.config.sample_rate

    def _window_channels(self) -> List[np.ndarray]:
        """Raw samples of the exact window range (fallback path)."""
        a, b = self._fps[0].window_sample_range()
        return [
            r[a - self._ring_start : b - self._ring_start]
            for r in self._rings if len(r)
        ]

    def recognize(self, topn: Optional[int] = None,
                  incremental: bool = True) -> Dict:
        """Recognize the current window (channel set-union, like the ref).

        incremental=True fingerprints only audio that arrived since the
        previous call; False recomputes the window from the sample ring
        (identical results, more device work).
        """
        import time

        from .match.prepare import prepare_query
        from .match.align import align_results

        if not incremental:
            return self.sia.recognize_samples(
                self._window_channels(), topn=topn
            )
        t0 = time.time()
        if not all(getattr(f, "ready", True) for f in self._fps):
            # the device engine can't serve a window until its first
            # 16-frame quantum lands — recompute from the sample ring
            return self.sia.recognize_samples(
                self._window_channels(), topn=topn
            )
        while True:
            try:
                fps = [
                    f.fingerprints(capacity=self._peak_cap)
                    for f in self._fps
                    if f.n_frames > f.window_bounds[0]
                ]
                if not fps:   # no frames at all yet (sub-wsize feed)
                    fps = [self._fps[0].fingerprints(
                        capacity=self._peak_cap)]
                break
            except OverflowError as e:
                # dense window: escalate like SIA's query path instead
                # of silently recomputing every future window from
                # scratch (sticky — one new program shape, then cached).
                # Jump straight to a tier that fits the known count:
                # every intermediate tier would be a wasted compile
                if not getattr(e, "escalate", True) \
                        or self._peak_cap >= (1 << 22):
                    # per-frame overflow (device ring): no capacity fixes
                    # it — recompute the window exactly
                    return self.sia.recognize_samples(
                        self._window_channels(), topn=topn
                    )
                need = getattr(e, "n_peaks", 0)
                self._peak_cap *= 2
                while self._peak_cap < need and self._peak_cap < (1 << 22):
                    self._peak_cap *= 2
        q = prepare_query(fps)
        fingerprint_time = time.time() - t0

        a, b = self._fps[0].window_sample_range()
        t0 = time.time()
        raw_matcher = getattr(self.sia, "_match_prepared", None)
        if raw_matcher is not None:
            raw, cap_used = raw_matcher(q, n_samples=b - a, topn=topn)
            query_time = time.time() - t0
            t0 = time.time()
            matched = align_results(
                raw, q.n_pairs, catalog=self.sia.catalog,
                config=self.sia.config, match_capacity=cap_used,
            )
            align_time = time.time() - t0
        else:
            # SIA-shaped facades (parallel.serving.ShardedRecognizer)
            # expose an aligned prepared-query match spanning the mesh
            matched = self.sia.match_prepared(q, topn=topn)
            query_time = time.time() - t0
            align_time = 0.0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": q.n_pairs,
            "fingerprint_time": fingerprint_time,
            "query_time": query_time,
            "align_time": align_time,
            "total_time": fingerprint_time + query_time + align_time,
        }

    def reset(self) -> None:
        for f in self._fps:
            f.reset()
        self._rings = [np.zeros(0, np.int16) for _ in range(self.channels)]
        self._ring_start = 0


def mic_chunks(seconds: float, channels: int = 2, rate: int = 44100,
               chunk: int = CHUNK) -> Iterator[np.ndarray]:
    """Yield interleaved int16 mic chunks via pyaudio (if installed).

    Mirrors the capture loop at ``recognizer.py:357-374``. Raises a clear
    error when pyaudio is unavailable (this container has no audio I/O).
    """
    try:
        import pyaudio
    except ImportError as exc:
        raise RuntimeError(
            "microphone capture requires pyaudio, which is not installed; "
            "use StreamRecognizer.feed() with your own chunk source"
        ) from exc

    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=channels, rate=rate,
                     input=True, frames_per_buffer=chunk)
    try:
        for _ in range(int(rate / chunk * seconds)):
            data = stream.read(chunk, exception_on_overflow=False)
            yield np.frombuffer(data, np.int16)
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()


def recognize_from_mic(sia: SIA, seconds: float = 5.0, channels: int = 2,
                       topn: Optional[int] = None) -> Dict:
    """One-shot mic recognition (the reference's recognizer.py main path)."""
    rec = StreamRecognizer(sia, channels=channels,
                           window_seconds=max(seconds, 1.0))
    for chunk in mic_chunks(seconds, channels=channels,
                            rate=sia.config.sample_rate):
        rec.feed(chunk)
    return rec.recognize(topn=topn)

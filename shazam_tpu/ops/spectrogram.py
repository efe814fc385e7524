"""dB power spectrogram with mlab.specgram semantics, as XLA-friendly JAX.

Matches reference ``fingerprint()`` (``__init__.py:232-241``):
``mlab.specgram(x, NFFT=4096, Fs, window=hanning, noverlap=2048)`` PSD
(one-sided, scale_by_freq) followed by ``10*log10`` with exact zeros kept
at zero.

Design notes:
- Framing is slice+concat (no gather): when ``hop`` divides ``wsize`` the
  signal reshapes into hop-sized rows and each frame is ``k = wsize/hop``
  consecutive rows — XLA fuses this into the FFT's input layout.
- Everything is batched over a leading time-frame axis so the FFT
  (``jnp.fft.rfft``: cuFFT on the GPU) and the elementwise PSD/dB math
  run as large fused ops.
- float32 end to end (the reference computes in float64 on CPU; parity is
  gated on recognition accuracy, see SURVEY.md §7 "Float parity"). Bins
  far below their frame's peak (~100 dB and more) are below float32's
  resolution in any FFT, so their dB values differ from the float64
  oracle by tenths of a dB; every bin above ``amp_min`` agrees to
  ~1e-4 dB.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np



def hann_window(wsize: int, dtype=jnp.float32) -> jnp.ndarray:
    """np.hanning(wsize): symmetric Hann incl. zero endpoints (mlab's window)."""
    k = np.arange(wsize)
    return jnp.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * k / (wsize - 1)), dtype=dtype)


def frame_signal(x: jnp.ndarray, wsize: int, hop: int) -> jnp.ndarray:
    """Overlapping frames, shape (n_frames, wsize), mlab layout (no padding).

    Frame i covers samples [i*hop, i*hop + wsize). Uses the slice+concat
    trick when hop | wsize; falls back to a strided gather otherwise.
    """
    n = x.shape[0]
    n_frames = (n - wsize) // hop + 1
    if n_frames <= 0:
        return jnp.zeros((0, wsize), x.dtype)
    if wsize % hop == 0:
        k = wsize // hop
        rows = x[: (n_frames + k - 1) * hop].reshape(n_frames + k - 1, hop)
        return jnp.concatenate([rows[j : j + n_frames] for j in range(k)], axis=1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(wsize)[None, :]
    return x[jnp.asarray(idx)]


@functools.partial(jax.jit, static_argnames=("fs", "wsize", "hop"))
def power_spectrogram(
    samples: jnp.ndarray, fs: int = 44100, wsize: int = 4096, hop: int = 2048,
) -> jnp.ndarray:
    """One-sided PSD spectrogram, shape (n_freqs, n_frames) like mlab's.

    Scaling matches mlab.specgram(mode='psd', scale_by_freq=True):
    |rfft(win * frame)|^2 / (fs * sum(win^2)), with all bins except DC and
    Nyquist doubled.
    """
    x = samples.astype(jnp.float32)
    win = hann_window(wsize)
    frames = frame_signal(x, wsize, hop) * win[None, :]
    spec = jnp.fft.rfft(frames, n=wsize, axis=1)
    power = spec.real * spec.real + spec.imag * spec.imag
    psd = power / (jnp.float32(fs) * jnp.sum(win * win))
    # one-sided doubling: every bin except DC and (for even NFFT) Nyquist
    scale = np.full(wsize // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if wsize % 2 == 0:
        scale[-1] = 1.0
    psd = psd * jnp.asarray(scale)[None, :]
    return psd.T  # (n_freqs, n_frames)


def db_spectrogram(psd: jnp.ndarray) -> jnp.ndarray:
    """10*log10 with exact zeros kept at 0 (reference ``__init__.py:241``)."""
    return jnp.where(psd != 0, 10.0 * jnp.log10(jnp.where(psd != 0, psd, 1.0)), 0.0)


@functools.partial(jax.jit, static_argnames=("fs", "wsize", "hop"))
def spectrogram_db(
    samples: jnp.ndarray, fs: int = 44100, wsize: int = 4096, hop: int = 2048,
) -> jnp.ndarray:
    """Fused PSD + dB pipeline: samples -> (n_freqs, n_frames) dB spectrogram."""
    return db_spectrogram(power_spectrogram(samples, fs=fs, wsize=wsize, hop=hop))

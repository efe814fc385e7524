"""Host-side audio I/O.

Equivalent of the reference's L0 layer (``__init__.py:70-113``,
``read()``): decode stays on the host CPU feeding fixed-shape device
buffers; the device never sees a file.

The reference decodes via pydub/ffmpeg (no ffmpeg binary here), so:

- WAV (PCM 8/16/32-bit and IEEE float) is decoded natively with the stdlib
  ``wave``/``struct`` machinery — zero dependencies, covers every fixture
  and benchmark corpus we generate.
- MP3 — the reference's corpus format (``__init__.py:86``) — decodes
  in-process through the system libmpg123 (``audio/mp3.py``, ctypes),
  which unlocks the reference's real-music fixture and its city-traffic
  noise recording in this environment.
- Any other container (flac, ogg, ... or mp3 without libmpg123) goes
  through the ``ffmpeg`` CLI *if present*; otherwise a clear error tells
  the user to transcode.

API mirrors the reference: ``read(path, limit) -> (channels, fs, sha1)``
where channels is a list of int16 numpy arrays (one per channel) and sha1
is the uppercase hex digest of the file bytes (``unique_hash``,
reference ``__init__.py:305-323``).
"""

from __future__ import annotations

import fnmatch
import hashlib
import io as _io
import os
import shutil
import struct
import subprocess
import wave
from typing import List, Optional, Sequence, Tuple

import numpy as np

_FFMPEG = shutil.which("ffmpeg")

WAV_EXTENSIONS = (".wav", ".wave")


def _mp3_available() -> bool:
    try:
        from .mp3 import available

        return available()
    except Exception:
        return False


def unique_file_hash(path: str, block_size: int = 2 ** 20) -> str:
    """SHA-1 of the file's bytes, uppercase hex (reference ``unique_hash``)."""
    digest = hashlib.sha1()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(block_size)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest().upper()


def find_files(path: str, extensions: Sequence[str]) -> List[Tuple[str, str]]:
    """Recursively list files matching the extensions (reference ``find_files``).

    Case-insensitive on the extension (TRACK01.WAV is a wav file on
    Linux too — fnmatch is case-sensitive there, so a plain filter
    silently skips upper-cased corpus files).
    """
    exts = [e.lstrip(".").lower() for e in extensions]
    results: List[Tuple[str, str]] = []
    for dirpath, _dirnames, files in os.walk(path):
        for name in files:
            suffix = name.rsplit(".", 1)[-1].lower() if "." in name else ""
            if suffix in exts:
                results.append((os.path.join(dirpath, name), suffix))
    return results


def probe(path: str) -> Optional[Tuple[int, int, int]]:
    """Header-only (n_channels, sample_rate, n_frames) — no decode.

    Lets ingest plan batches (bucket by length, size device buffers)
    before paying for decode. Returns None for containers that need a
    full decode to know (non-WAV without the native loader).
    """
    if not path.lower().endswith(WAV_EXTENSIONS):
        return None
    try:
        from .. import native

        info = native.wav_info(path)
        if info is not None:
            n_ch, rate, frames = info
            return n_ch, rate, frames
    except Exception:
        pass
    try:
        with wave.open(path, "rb") as wf:
            return wf.getnchannels(), wf.getframerate(), wf.getnframes()
    except Exception:
        pass
    try:
        # IEEE-float WAVs (stdlib wave rejects fmt tag 3): header-only
        # scan — 1 MB covers any sane metadata before the data chunk
        with open(path, "rb") as fh:
            scan = _riff_scan(fh.read(1 << 20))
        if scan is None or scan[0][0] != 3 or scan[0][5] != 32:
            return None
        (_, n_ch, fs, _br, _ba, _bits), _off, data_size = scan
        return n_ch, fs, data_size // (4 * n_ch)
    except Exception:
        return None


def _riff_scan(blob: bytes):
    """(fmt, data_offset, data_size) from RIFF/WAVE bytes, or None.

    ``fmt`` = (tag, n_channels, fs, byte_rate, block_align, bits).
    ``blob`` may be a truncated prefix as long as it reaches the data
    chunk HEADER — the body needn't be present (header-only ``probe``).
    The ONE chunk walk shared by probe and decode: float-WAV handling
    must not drift between two hand-rolled parsers.
    """
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        return None
    pos, fmt = 12, None
    while pos + 8 <= len(blob):
        cid = blob[pos: pos + 4]
        size = struct.unpack_from("<I", blob, pos + 4)[0]
        if cid == b"fmt " and pos + 8 + 16 <= len(blob):
            fmt = struct.unpack_from("<HHIIHH", blob, pos + 8)
        elif cid == b"data":
            if fmt is None:
                return None
            return fmt, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    return None


def _read_float_wav(src, limit: Optional[float]) -> Tuple[np.ndarray, int, int]:
    """IEEE-float WAV fallback: stdlib ``wave`` rejects fmt tag 3, so
    parse the RIFF chunks directly (the native loader handles these too;
    this keeps the pure-Python path at parity when it isn't built).
    ``src`` is a path or the raw RIFF bytes."""
    if isinstance(src, bytes):
        path, riff = "<bytes>", src
    else:
        path = src
        with open(src, "rb") as fh:
            riff = fh.read()
    scan = _riff_scan(riff)
    if scan is None:
        raise ValueError(f"{path}: not a RIFF/WAVE file with fmt+data")
    fmt, off, size = scan
    tag, n_channels, fs, _br, _ba, bits = fmt
    if tag != 3 or bits != 32:
        raise ValueError(
            f"{path}: unsupported WAV format tag {tag} / {bits} bits")
    data = riff[off: off + size]
    f = np.frombuffer(data[: len(data) // 4 * 4], dtype="<f4")
    # trim to whole FRAMES too: a truncated chunk ending mid-frame would
    # otherwise de-interleave into unequal channel lengths
    f = f[: len(f) // n_channels * n_channels]
    if limit is not None:
        f = f[: int(limit * fs) * n_channels]
    out = np.clip(f * 32768.0, -32768, 32767).astype(np.int16)
    return out, fs, n_channels


def _read_wav(src, limit: Optional[float]) -> Tuple[np.ndarray, int, int]:
    """Decode a PCM/float WAV (path or raw bytes) into an interleaved
    int16 array + sample rate."""
    try:
        return _read_pcm_wav(src, limit)
    except wave.Error as e:
        if "unknown format: 3" in str(e):
            return _read_float_wav(src, limit)
        raise


def _read_pcm_wav(src, limit: Optional[float]) -> Tuple[np.ndarray, int, int]:
    is_bytes = isinstance(src, bytes)
    with wave.open(_io.BytesIO(src) if is_bytes else src, "rb") as wf:
        n_channels = wf.getnchannels()
        fs = wf.getframerate()
        sampwidth = wf.getsampwidth()
        n_frames = wf.getnframes()
        if limit is not None:
            n_frames = min(n_frames, int(limit * fs))
        raw = wf.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.int16)
    elif sampwidth == 1:  # unsigned 8-bit
        data = ((np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128) << 8)
        data = data.astype(np.int16)
    elif sampwidth == 4:
        # Could be int32 PCM or float32; wave module doesn't expose the
        # format tag, so walk the RIFF chunks (the ONE shared parser —
        # a raw header sniff misreads files with JUNK/LIST before fmt).
        if is_bytes:
            head = src[: 1 << 20]
        else:
            with open(src, "rb") as fh:
                head = fh.read(1 << 20)
        scan = _riff_scan(head)
        fmt_tag = scan[0][0] if scan is not None else 1
        if fmt_tag == 3:
            f = np.frombuffer(raw, dtype="<f4")
            data = np.clip(f * 32768.0, -32768, 32767).astype(np.int16)
        else:
            data = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.int16)
    elif sampwidth == 3:  # 24-bit PCM
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = (val << 8) >> 16  # sign-extend then keep top 16 bits
        data = val.astype(np.int16)
    else:
        src_name = "<bytes>" if is_bytes else src
        raise ValueError(
            f"unsupported WAV sample width {sampwidth} in {src_name}")

    return data.reshape(-1)[: n_frames * n_channels], fs, n_channels


def _read_via_ffmpeg(path: str, limit: Optional[float]) -> Tuple[np.ndarray, int, int]:
    """Decode any container through the ffmpeg CLI to s16le PCM."""
    if _FFMPEG is None:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and no ffmpeg binary found; "
            "transcode to WAV first"
        )
    probe = subprocess.run(
        [_FFMPEG, "-i", path, "-f", "null", "-"],
        capture_output=True, text=True,
    )
    # parse "Audio: ..., 44100 Hz, stereo|mono|5.1|N channels" from stderr;
    # the decode below forces -ac n_channels so a misparse can garble the
    # de-interleave — fail loudly on layouts we can't name
    fs, n_channels = None, None
    for line in probe.stderr.splitlines():
        if "Audio:" in line:
            for part in line.split(","):
                part = part.strip()
                if part.endswith("Hz"):
                    fs = int(part.split()[0])
                elif part.startswith("mono"):
                    n_channels = 1
                elif part.startswith("stereo"):
                    n_channels = 2
                elif part.endswith("channels") and part.split()[0].isdigit():
                    n_channels = int(part.split()[0])
                elif part.replace(".", "").isdigit() and "." in part:
                    # "5.1", "7.1" style layouts: total = main + LFE
                    main, lfe = part.split(".", 1)
                    n_channels = int(main) + int(lfe)
            break
    if n_channels is None or fs is None:
        # a defaulted sample rate would pass recognize_file's fs guard
        # and pitch-shift every hash — silent accuracy collapse
        raise ValueError(
            f"cannot determine sample rate / channel layout of {path!r} "
            "from ffmpeg probe; transcode to WAV first"
        )
    cmd = [_FFMPEG, "-v", "quiet", "-i", path]
    if limit is not None:
        cmd += ["-t", str(limit)]
    # pin the decode to the probed values: -map 0:a:0 selects the FIRST
    # audio stream (the one the probe's first 'Audio:' line described —
    # ffmpeg's default 'best stream' pick can differ in multi-stream
    # containers), -ar/-ac force the rate/channels so the returned
    # (samples, fs) pair can never disagree silently
    cmd += ["-map", "0:a:0", "-f", "s16le", "-acodec", "pcm_s16le",
            "-ar", str(fs), "-ac", str(n_channels), "-"]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        # a failed decode must be a clear error, not silently-empty
        # audio fingerprinted as silence
        raise ValueError(
            f"ffmpeg failed to decode {path!r} (exit {proc.returncode})")
    return (np.frombuffer(proc.stdout, dtype="<i2").astype(np.int16),
            fs, n_channels)


def read(path: str, limit: Optional[float] = None):
    """Decode an audio file.

    :param path: audio file path (WAV natively; others via ffmpeg if present).
    :param limit: optional seconds to keep from the start.
    :return: (channels, sample_rate, file_sha1) — channels is a list of
        int16 arrays, one per channel (de-interleaved like reference
        ``__init__.py:93-95``).

    WAV files route through the C++ data-loader (shazam_tpu/native) when
    it is built — GIL-free decode + SHA-1, bit-identical to the Python
    path below, which remains the fallback.
    """
    if path.lower().endswith(WAV_EXTENSIONS):
        try:
            from .. import native

            out = native.decode_all(path, limit)
            if out is not None:
                return out
        except Exception:
            pass
        data, fs, n_channels = _read_wav(path, limit)
    elif path.lower().endswith(".mp3") and _mp3_available():
        from .mp3 import decode_mp3

        try:
            data, fs, n_channels = decode_mp3(path, limit)
        except Exception:
            # mpg123 rejects the stream (corrupt, or a mis-extensioned
            # container): ffmpeg sniffs by content and previously owned
            # this route — keep that coverage when it is present.
            if _FFMPEG is None:
                raise
            data, fs, n_channels = _read_via_ffmpeg(path, limit)
    else:
        data, fs, n_channels = _read_via_ffmpeg(path, limit)
    channels = [np.ascontiguousarray(data[c::n_channels]) for c in range(n_channels)]
    return channels, fs, unique_file_hash(path)


def read_wav_bytes(blob: bytes, limit: Optional[float] = None):
    """Decode an in-memory WAV payload: ``(channels, fs)``.

    The serving hot path (``serve.py``): same decode semantics as
    ``read()`` on a ``.wav`` file, minus the disk spool and the file
    SHA-1 recognition discards anyway.  Non-RIFF payloads raise — spool
    those to a file and use ``read()`` (ffmpeg needs a path)."""
    if blob[:4] != b"RIFF":
        raise ValueError("payload is not RIFF/WAVE; transcode to WAV")
    data, fs, n_channels = _read_wav(blob, limit)
    channels = [
        np.ascontiguousarray(data[c::n_channels]) for c in range(n_channels)
    ]
    return channels, fs


def write_wav(path: str, samples: np.ndarray, fs: int = 44100) -> None:
    """Write mono/stereo int16 or float [-1,1] samples as a 16-bit PCM WAV."""
    arr = np.asarray(samples)
    if arr.dtype.kind == "f":
        # same convention as the client SDK's encoder (scale 32767,
        # round, clip — truncation made 0.5 encode differently here vs
        # there) so a float signal writes to bit-identical int16 PCM
        # whichever writer produced it
        arr = np.clip(np.rint(arr * 32767.0), -32768, 32767).astype(np.int16)
    arr = arr.astype(np.int16)
    if arr.ndim == 1:
        n_channels, frames = 1, arr
    else:
        n_channels = arr.shape[0]
        frames = arr.T.reshape(-1)  # interleave
    with wave.open(path, "wb") as wf:
        wf.setnchannels(n_channels)
        wf.setsampwidth(2)
        wf.setframerate(fs)
        wf.writeframes(frames.tobytes())

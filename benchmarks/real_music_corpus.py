"""Real-music mini-corpus sweep: variants of the reference's own MP3.

The input is one real recording, ``RMC_MP3`` (the reference project's
ES-path test fixture ``songsES/000002.mp3``, 30 s stereo, is what this
was written for; it is not part of this repository). The at-scale
accuracy numbers here run on a synthetic generator *validated against*
real-music statistics; this bench anchors that validation on actual
music: it derives a catalog of distinct "songs" from the real recording
— pitch/tempo-shifted variants (play-rate resampling, |shift| >= 3% per
step, far past fingerprint tolerance) — then sweeps clips through

- clean recognition,
- city-traffic noise at 0 dB SNR (the reference's own robustness
  experiment, ``recognizer_test.py:426-435``),
- the synthetic acoustic channel at the calibrated severity.

Accuracy = the clip's variant wins top-1 (its own constellations,
against 20+ siblings that are the SAME music at shifted rates — a
harder near-collision corpus than unrelated songs).

Catalog axes (every entry derived from the one real recording):

- rate: 1.03 ** k play-rate variants (the proven >= 3%-step separation
  axis — pitch AND tempo shift together, like vinyl speed);
- segment (``RMC_SEGMENTS`` > 1): non-overlapping time slices of the
  recording are DIFFERENT music content, multiplying the catalog
  without manufacturing same-content near-dups (3 segments x 32 rates
  = a 96-entry real-audio catalog).

Query-side stress sweeps (clip transforms — catalog unchanged, so
accuracy stays well-defined): clean, city-traffic @ 0 dB SNR (the
reference's own robustness experiment), the calibrated synthetic
acoustic channel, a +6 dB/oct treble EQ tilt, and a 300-3400 Hz
phone-band limit (stem-style filtering).

Env: RMC_MP3 (the recording, required), RMC_NOISE (the reference's
city-traffic MP3; the noise sweep is skipped without it),
RMC_VARIANTS (rates, default 24), RMC_SEGMENTS (default 1),
RMC_CLIP (default 5.0 s), RMC_PER (clips/variant, default 4),
RMC_SEVERITY (channel severity, default
audio.channel.CALIBRATED_SEVERITY).
Run: RMC_MP3=path/to/000002.mp3 python benchmarks/real_music_corpus.py
(CPU ok: JAX_PLATFORMS=cpu)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MP3 = os.environ.get("RMC_MP3")
NOISE = os.environ.get("RMC_NOISE")
N_VARIANTS = int(os.environ.get("RMC_VARIANTS", 24))
N_SEGMENTS = int(os.environ.get("RMC_SEGMENTS", 1))
CLIP_S = float(os.environ.get("RMC_CLIP", 5.0))
PER = int(os.environ.get("RMC_PER", 4))
FS = 44100


def main():
    from shazam_tpu import SIA
    from shazam_tpu.audio.mp3 import decode_mp3
    from shazam_tpu.audio.resample import resample_channel
    from shazam_tpu.audio.channel import CALIBRATED_SEVERITY, \
        simulate_channel
    from shazam_tpu.audio.noise import mix_at_snr

    severity = float(os.environ.get("RMC_SEVERITY", CALIBRATED_SEVERITY))

    if not MP3:
        raise SystemExit("set RMC_MP3 to the recording to derive the "
                         "catalog from")
    pcm, fs, nch = decode_mp3(MP3)
    mono = pcm.reshape(-1, nch).mean(axis=1).astype(np.float64)
    if fs != FS:
        mono = resample_channel(mono.astype(np.int16), fs, FS)
    mono = np.asarray(mono, np.float64)
    print(f"fixture: {len(mono)/FS:.1f} s real music", flush=True)

    # pitch/tempo variants: re-rate by f (resample fs -> fs/f, relabel
    # as fs). 3% steps keep every pair >= one full step apart. With
    # RMC_SEGMENTS > 1, each non-overlapping slice of the recording is
    # its own source (different music content), so segments x rates
    # scales the catalog without same-content near-dups.
    ks = list(range(-(N_VARIANTS // 2), N_VARIANTS - N_VARIANTS // 2))
    seg_len = len(mono) // N_SEGMENTS
    songs = []
    for seg in range(N_SEGMENTS):
        src = mono[seg * seg_len: (seg + 1) * seg_len]
        for k in ks:
            f = 1.03 ** k
            target = int(round(FS / f))
            v = resample_channel(
                np.clip(src, -32768, 32767).astype(np.int16), FS, target)
            name = (f"seg{seg}var{k:+03d}" if N_SEGMENTS > 1
                    else f"var{k:+03d}")
            songs.append((name, np.asarray(v, np.float32)))
    print(f"{len(songs)} variants ({N_SEGMENTS} segments x {len(ks)} "
          f"rates, factors 1.03^({ks[0]}..{ks[-1]}))", flush=True)

    sia = SIA()
    t0 = time.time()
    stats = sia.ingest_arrays(songs)
    print(f"ingested {stats['hashes']} hashes in {time.time()-t0:.0f}s",
          flush=True)

    noise = None
    if NOISE and os.path.exists(NOISE):
        npcm, nfs, nnch = decode_mp3(NOISE)
        noise = npcm.reshape(-1, nnch).mean(axis=1).astype(np.int16)
        if nfs != FS:
            noise = resample_channel(noise, nfs, FS)

    rng = np.random.default_rng(20260820)

    def sweep(tag, transform):
        hits = 0
        trials = 0
        for vi, (name, samples) in enumerate(songs):
            n = len(samples)
            for j in range(PER):
                a = int(rng.integers(0, max(n - int(CLIP_S * FS), 1)))
                clip = samples[a: a + int(CLIP_S * FS)].astype(np.int16)
                clip = transform(clip, 1000 * vi + j)
                out = sia.recognize_samples([clip.astype(np.float32)])
                got = (out["results"][0]["song_name"]
                       if out["results"] else None)
                hits += got == name
                trials += 1
        print(f"ACCURACY [{tag}] {hits/trials:.4f} "
              f"({hits}/{trials} x {CLIP_S:.0f}s clips, "
              f"{len(songs)} real-music variants)", flush=True)

    def noisy(c, s):
        # mix_at_snr returns renormalized [-1, 1] floats; the pipeline's
        # amp_min threshold assumes int16 scale (same as catalog_full)
        mixed = mix_at_snr(c, noise, 0.0, rng=np.random.default_rng(s))
        return np.clip(mixed * 32767.0, -32768, 32767).astype(np.int16)

    from scipy.signal import butter, sosfilt

    def eq_tilt(c, s):
        # +6 dB/oct treble tilt: y = x + g * dx (first difference adds
        # a zero at DC) — a bright mastering/EQ chain on the query side
        x = c.astype(np.float64)
        y = x + 2.5 * np.diff(x, prepend=x[:1])
        y *= np.sqrt(np.sum(x * x) / max(np.sum(y * y), 1e-9))
        return np.clip(y, -32768, 32767).astype(np.int16)

    phone_sos = butter(4, [300 / (FS / 2), 3400 / (FS / 2)],
                       btype="band", output="sos")

    def phone_band(c, s):
        # 300-3400 Hz band limit (telephone / heavily-stemmed mix)
        y = sosfilt(phone_sos, c.astype(np.float64))
        y *= np.sqrt(max(np.sum(c.astype(np.float64) ** 2), 1.0)
                     / max(np.sum(y * y), 1e-9))
        return np.clip(y, -32768, 32767).astype(np.int16)

    sweep("clean", lambda c, s: c)
    if noise is not None:
        sweep("0 dB city", noisy)
    sweep(f"channel sev={severity:g}", lambda c, s: simulate_channel(
        c, fs=FS, rng=np.random.default_rng(s), severity=severity))
    sweep("eq +6dB/oct tilt", eq_tilt)
    sweep("phone band 300-3400", phone_band)


if __name__ == "__main__":
    main()

"""Device-side (JAX) music-like song generator for at-scale benchmarks.

The host generator (``synth.synth_music_song``) renders seconds per song
on one host core — a 2,714-track corpus would cost hours plus a ~50 GB
upload. This module renders the same DESIGN on the device
(catalog_full.py's and chip_smoke.py's zero-copy ingest consume it
straight from device memory): sustained harmonic voices over a per-song chord
progression with vibrato, a melody walk, section dynamics and a
percussion bed — the statistics that make robustness sweeps behave like
real music (reference ``songs_queries.sql:11`` density; the graceful SNR
curve of ``tests_csv/shazam_results_100records_5sec_0SNR.csv``).

Shape contract (catalog_full.py): ``make_music_gen(duration_s)`` returns
``gen(sids) -> (B, BLEN) float32`` of int16-valued samples, BLEN =
next-multiple-of-2^18 of N_BLOCKS*BLOCK. All voice frequencies are
piecewise-constant per BLOCK (=8192 samples, ~0.19 s) with phase
continuity via cumulative per-block phase steps; note envelopes are
exact per sample (attack*decay off the note age); vibrato is phase
modulation at the FM-equivalent index; harmonics come from one sin/cos
pair via Chebyshev recurrences (no extra transcendentals). Percussion
lands at exact sample positions via scatter-add, like catalog_full's
click bed. The hits of one scatter never overlap inside the song (only
in the discarded dump zone past its end), so the float sums do not
depend on the order a GPU's atomic adds land in: ``gen(sids)`` is
bit-identical across calls (``chip_smoke.py`` checks it on the card).

Everything is deterministic in (seed, song_id, duration_s, level).
"""

from __future__ import annotations

import numpy as np

FS = 44100
BLOCK = 8192


def make_music_gen(duration_s: float, fs: int = FS, seed: int = 77,
                   level: float = 0.15, quiet: float = 0.72):
    """Build the jitted (B,) int32 sids -> (B, BLEN) float32 generator."""
    import jax
    import jax.numpy as jnp
    from jax import lax, random

    n_samp = int(duration_s * fs)
    n_blocks = n_samp // BLOCK + 1
    n_gen = n_blocks * BLOCK
    blen = -(-n_gen // (1 << 18)) * (1 << 18)

    two_pi = np.float32(2.0 * np.pi)
    inv_fs = np.float32(1.0 / fs)
    ramp = jnp.arange(BLOCK, dtype=jnp.float32)
    # scale tables: degree -> semitone, 3+ octaves of walk headroom
    major = np.array([0, 2, 4, 5, 7, 9, 11], np.float32)
    minor = np.array([0, 2, 3, 5, 7, 8, 10], np.float32)
    deg_idx = np.arange(24)
    maj_tab = jnp.asarray(major[deg_idx % 7] + 12 * (deg_idx // 7))
    min_tab = jnp.asarray(minor[deg_idx % 7] + 12 * (deg_idx // 7))

    max_bars = n_blocks // 8 + 2          # bar >= 8 blocks
    prog_len = 8

    def render_voice(freqs, amp, age0, atk, dec, vib_hz, vib_beta, ph0,
                     hgains):
        """One per-block piecewise voice -> (n_gen,) samples.

        freqs/amp/age0/dec/vib_beta: (n_blocks,); atk/vib_hz/ph0 scalar.
        Envelope per sample: amp * min(1, t*atk) * exp(-dec*t) with
        t = age0[block] + in-block time (exact note age, no block
        quantization -> no onset clicks).
        """
        steps = two_pi * freqs * inv_fs                    # (n_blocks,)
        starts = jnp.mod(
            jnp.concatenate([jnp.zeros(1, jnp.float32),
                             jnp.cumsum(steps * BLOCK)[:-1]]), two_pi)
        t_abs = (jnp.arange(n_blocks, dtype=jnp.float32)[:, None] * BLOCK
                 + ramp[None, :]) * inv_fs                  # (nb, BLOCK)
        phase = (starts[:, None] + steps[:, None] * ramp[None, :]
                 + vib_beta[:, None]
                 * jnp.sin(two_pi * vib_hz * t_abs + ph0))
        s = jnp.sin(phase)
        c = jnp.cos(phase)
        s2 = 2.0 * s * c                    # Chebyshev harmonics
        c2 = 1.0 - 2.0 * s * s
        s3 = s2 * c + c2 * s
        s4 = 2.0 * s2 * c2
        wave = (hgains[0] * s + hgains[1] * s2
                + hgains[2] * s3 + hgains[3] * s4)
        t_note = age0[:, None] + ramp[None, :] * inv_fs
        env = (amp[:, None] * jnp.minimum(1.0, t_note * atk)
               * jnp.exp(-dec[:, None] * t_note))
        return (wave * env).reshape(-1)

    def one_song(sid):
        key = random.fold_in(random.PRNGKey(seed), sid)
        ks = random.split(key, 12)

        detune = 2.0 ** (random.uniform(ks[0], (), minval=-0.5,
                                        maxval=0.5) / 12.0)
        a4 = 440.0 * detune
        key_off = random.randint(ks[1], (), 0, 12).astype(jnp.float32)
        is_major = random.bernoulli(ks[2])
        tab = jnp.where(is_major, maj_tab, min_tab)

        def degree_hz(deg, octave):
            semis = key_off + tab[jnp.clip(deg, 0, 23)]
            return a4 * 2.0 ** ((semis - 57.0 + 12.0 * octave) / 12.0)

        bar_blocks = random.randint(ks[3], (), 8, 17)       # ~1.5-3.2 s
        half_blocks = jnp.maximum(bar_blocks // 2, 1)
        blk = jnp.arange(n_blocks)
        bar_of = blk // bar_blocks
        prog = jnp.concatenate([
            jnp.zeros(1, jnp.int32),
            random.randint(ks[4], (prog_len - 1,), 1, 6)])
        chord = prog[bar_of % prog_len]

        # section dynamics: alternate 8-bar quiet/loud contours
        sect_bar = jnp.where((jnp.arange(max_bars) // 8) % 2 == 0,
                             np.float32(quiet), np.float32(1.0))
        sect_bar = sect_bar * random.uniform(
            ks[5], (max_bars,), minval=0.9, maxval=1.1)
        sect = sect_bar[jnp.clip(bar_of, 0, max_bars - 1)]

        # --- bass: chord root per half-bar, no vibrato ---
        age_b = (blk % half_blocks).astype(jnp.float32) * BLOCK * inv_fs
        bass = render_voice(
            degree_hz(chord, 2), 0.9 * sect, age_b, np.float32(60.0),
            jnp.full(n_blocks, 0.8, jnp.float32),
            jnp.float32(1.0), jnp.zeros(n_blocks, jnp.float32),
            jnp.float32(0.0),
            jnp.asarray([1.0, 0.5, 0.2, 0.0], jnp.float32))

        # --- pad: 3 chord tones, per-bar attack/decay, gentle vibrato ---
        age_p = (blk % bar_blocks).astype(jnp.float32) * BLOCK * inv_fs
        pad = jnp.zeros(n_gen, jnp.float32)
        for j, off in enumerate((0, 2, 4)):
            f = degree_hz(chord + off, 4)
            vhz = random.uniform(random.fold_in(ks[6], j), (),
                                 minval=4.0, maxval=6.0)
            vcents = random.uniform(random.fold_in(ks[7], j), (),
                                    minval=4.0, maxval=10.0)
            beta = f * (2.0 ** (vcents / 1200.0) - 1.0) / vhz
            pad = pad + render_voice(
                f, 0.35 * sect, age_p, np.float32(6.0),
                jnp.full(n_blocks, 0.25, jnp.float32), vhz, beta,
                random.uniform(random.fold_in(ks[8], j), (),
                               minval=0.0, maxval=two_pi),
                jnp.asarray([1.0, 0.45, 0.22, 0.10], jnp.float32))

        # --- melody: scan over blocks; notes of 2-6 blocks, walk over
        # scale degrees around octave 5, ~15% rests ---
        def mel_step(carry, kb):
            deg, left, gate, dec = carry
            knew = random.split(kb, 4)
            new_note = left <= 0
            nlen = random.choice(knew[0],
                                 jnp.asarray([2, 2, 3, 3, 4, 6]))
            step = random.choice(
                knew[1], jnp.asarray([-2, -1, -1, 1, 1, 2, 3]))
            ndeg = jnp.clip(deg + step, 4, 20)
            ngate = (random.uniform(knew[2], ()) < 0.85).astype(
                jnp.float32)
            ndec = random.uniform(knew[3], (), minval=0.8, maxval=2.0)
            deg = jnp.where(new_note, ndeg, deg)
            gate = jnp.where(new_note, ngate, gate)
            dec = jnp.where(new_note, ndec, dec)
            left = jnp.where(new_note, nlen, left)
            return (deg, left - 1, gate, dec), (deg, new_note, gate, dec)

        kblocks = random.split(ks[9], n_blocks)
        _, (deg_b, new_b, gate_b, dec_b) = lax.scan(
            mel_step, (jnp.int32(10), jnp.int32(0), jnp.float32(1.0),
                       jnp.float32(1.0)), kblocks)
        idx = jnp.arange(n_blocks)
        last_new = lax.associative_scan(          # cummax of note starts
            jnp.maximum, jnp.where(new_b, idx, 0))
        age_m = (idx - last_new).astype(jnp.float32) * BLOCK * inv_fs
        vhz_m = random.uniform(ks[10], (), minval=4.5, maxval=6.5)
        vcents_m = random.uniform(random.fold_in(ks[10], 1), (),
                                  minval=8.0, maxval=25.0)
        f_mel = degree_hz(deg_b, 4)
        mel = render_voice(
            f_mel, 0.75 * sect * gate_b, age_m, np.float32(30.0), dec_b,
            vhz_m, f_mel * (2.0 ** (vcents_m / 1200.0) - 1.0) / vhz_m,
            random.uniform(random.fold_in(ks[10], 2), (),
                           minval=0.0, maxval=two_pi),
            jnp.asarray([1.0, 0.45, 0.22, 0.10], jnp.float32))

        audio = bass + pad + mel

        # --- percussion bed: kick beats 0/2, snare 1/3, hats on 8ths ---
        bar_samp = bar_blocks * BLOCK
        beat_samp = bar_samp // 4
        bars = jnp.arange(max_bars)
        amp_bar = sect_bar
        klen = int(0.09 * fs)
        kt = jnp.arange(klen, dtype=jnp.float32) * inv_fs
        kick = jnp.sin(two_pi * (90.0 * jnp.exp(-kt * 18.0) + 45.0) * kt
                       ) * jnp.exp(-kt * 35.0)
        slen = int(0.07 * fs)
        snoise = random.normal(random.fold_in(key, 101), (slen,))
        snare = (snoise - 0.5 * jnp.concatenate(
            [jnp.zeros(1), snoise[:-1]])) * jnp.exp(
            -jnp.arange(slen) / (0.012 * fs))
        hlen = int(0.02 * fs)
        hnoise = random.normal(random.fold_in(key, 102), (hlen,))
        hat = jnp.diff(hnoise, prepend=0.0) * jnp.exp(
            -jnp.arange(hlen) / (0.004 * fs))

        # dump zone for hits past the song end (guard >= longest wave)
        total = n_gen + klen + 16
        audio = jnp.concatenate(
            [audio, jnp.zeros(klen + 16, jnp.float32)])

        def add_hits(aud, positions, wave, amps):
            pos = jnp.where(positions + wave.shape[0] < n_gen,
                            positions, total - wave.shape[0] - 1)
            return aud.at[pos[:, None]
                          + jnp.arange(wave.shape[0])[None, :]].add(
                amps[:, None] * wave[None, :])

        for bt, wave, g in ((0, kick, 0.5), (2, kick, 0.5),
                            (1, snare, 0.18), (3, snare, 0.18)):
            audio = add_hits(audio, bars * bar_samp + bt * beat_samp,
                             wave, g * amp_bar)
        for half in range(8):
            audio = add_hits(audio,
                             bars * bar_samp + half * (beat_samp // 2),
                             hat, 0.05 * amp_bar)
        audio = audio[:n_gen]

        audio = audio + random.normal(random.fold_in(key, 103),
                                      (n_gen,)) * 0.004
        peak = jnp.max(jnp.abs(audio))
        audio = audio / jnp.maximum(peak, 1e-6) * level
        audio = jnp.round(audio[:n_samp] * 32767.0)
        return jnp.pad(audio, (0, blen - n_samp))

    @jax.jit
    def gen(sids):
        return jax.vmap(one_song)(sids)

    gen.n_samp = n_samp
    gen.blen = blen
    return gen

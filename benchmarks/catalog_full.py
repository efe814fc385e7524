"""Reference-scale catalog benchmark: 2,714 FULL-LENGTH tracks, 15 s clips.

The reference's headline (BASELINE.md row 1) is 2,714 full songs at ~11-12K hashes/song
(``songs_queries.sql:11``), ~30M hashes total.  This bench builds that
catalog and runs:

- a 300-clip 15 s recognition sweep through the PRODUCTION host API
  (each clip downloaded as int16 and fed to ``recognize_samples`` —
  upload + query + align, exactly like a real client) -> accuracy,
- the single-dispatch ``recognize_on_device`` chained device latency.

The corpus is synthesized ON the device and ingested with the zero-copy
device path (``api.ingest_device_batch``): fingerprints, sorted runs and
merges never leave device memory.  Uploading ~50 GB of raw audio is not
part of the measured workload; the generated density (~11K hashes/song)
matches the reference corpus.

Bitwise ingest/sweep agreement: every clip is cut from a song
regenerated by the SAME jitted program with the SAME batch shape and
inputs as during ingest, so the sliced samples are identical bit for bit.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_SONGS = int(os.environ.get("CATALOG_SONGS", 2714))
DURATION = float(os.environ.get("CATALOG_DURATION", 210.0))
CLIP_S = float(os.environ.get("CATALOG_CLIP", 15.0))
N_CLIPS = int(os.environ.get("CATALOG_CLIPS", 300))
# optional noise sweep(s): comma-separated SNR dBs, one 300-clip sweep
# per value over the SAME ingested catalog (reference noise mode,
# recognizer_test.py:412-423); unset = one clean sweep.
# CATALOG_NOISE_FILE=path mixes that recording at each SNR instead of
# AWGN — with the reference's city-traffic MP3 this reproduces its
# exact robustness experiment (recognizer_test.py:426-435).
SNRS = ([None if s.strip() == "clean" else float(s)
         for s in os.environ["CATALOG_SNR"].split(",")]
        if os.environ.get("CATALOG_SNR") else [None])
NOISE_FILE = os.environ.get("CATALOG_NOISE_FILE")
FS = 44100
BATCH = int(os.environ.get("CATALOG_BATCH", 8))
BLOCK = 8192

N_SAMP = int(DURATION * FS)
N_BLOCKS = N_SAMP // BLOCK + 1
N_GEN = N_BLOCKS * BLOCK
BLEN = -(-N_GEN // (1 << 18)) * (1 << 18)


def _make_gen():
    """jitted (B,) sids -> (B, BLEN) float32 songs (int16-valued).

    CATALOG_STYLE=music swaps in the music-like device generator
    (shazam_tpu/audio/synth_device.py — sustained harmonic voices,
    validated against real-music hash density and SNR shape); the
    default remains the original percussive-tone corpus.
    """
    if os.environ.get("CATALOG_STYLE") == "music":
        from shazam_tpu.audio.synth_device import make_music_gen

        gen = make_music_gen(DURATION, fs=FS)
        assert gen.blen == BLEN, (gen.blen, BLEN)
        return gen
    return _make_tones_gen()


def _make_tones_gen():
    """jitted (B,) sids -> (B, BLEN) float32 songs (int16-valued)."""
    import jax
    import jax.numpy as jnp
    from jax import lax, random

    two_pi = np.float32(2 * np.pi)
    ramp = jnp.arange(BLOCK, dtype=jnp.float32)
    tck = jnp.arange(441, dtype=jnp.float32)

    def one_voice(key):
        kw, kf, ke = random.split(key, 3)
        # variance-stabilized walk (smooth, STATIONARY): a raw
        # exp(cumsum) walk saturates at the frequency clamps by late
        # song, making every song's tail spectrally alike — tail clips
        # then share hyper-hot hash buckets and lose discriminative
        # power (the 7,986-song run's misses all clustered at tails)
        steps = jnp.cumsum(random.normal(kw, (N_BLOCKS,)))
        walk = jnp.exp(0.35 * steps
                       / jnp.sqrt(jnp.arange(N_BLOCKS) + 1.0))
        # fundamentals >= ~190 Hz: the corpus this generator defines
        # (kept unchanged so earlier builds stay reproducible)
        f = jnp.clip(random.uniform(kf, (), minval=240.0, maxval=900.0)
                     * walk, 190.0, 3500.0)
        step = two_pi * f / FS                            # (N_BLOCKS,)
        starts = jnp.mod(
            jnp.concatenate([jnp.zeros(1), jnp.cumsum(step * BLOCK)[:-1]]),
            two_pi,
        )
        phase = starts[:, None] + step[:, None] * ramp    # (N_BLOCKS, BLOCK)
        env = random.uniform(ke, (N_BLOCKS, 1), minval=0.15, maxval=1.0)
        s = jnp.sin(phase)
        c = jnp.cos(phase)
        # harmonics from one sin/cos pair: sin2x = 2sc, sin3x = s(3-4s^2)
        return (env * (s + c * s + 0.25 * s * (3.0 - 4.0 * s * s))).reshape(-1)

    def one_song(sid):
        key = random.fold_in(random.PRNGKey(77), sid)
        kv, kh, ka, kn = random.split(key, 4)

        def voice_step(acc, k):
            return acc + one_voice(k), None

        audio, _ = lax.scan(voice_step, jnp.zeros(N_GEN, jnp.float32),
                            random.split(kv, 3))
        # percussive clicks, >= 2 blocks apart: two impulses inside one
        # 4096 frame make an interference comb (ripple ~4096/dt bins)
        # that packs 9-12 maxima into a group
        nck = int(DURATION * 2)
        blocks = random.choice(kh, (N_BLOCKS - 1) // 2, shape=(nck,),
                               replace=False)
        hits = blocks * (2 * BLOCK) + random.randint(
            random.fold_in(kh, 1), (nck,), 0, BLOCK)
        amps = random.normal(ka, (nck, 1)) * 0.8
        # per-hit timbre (damped sine with random carrier/decay): a
        # SHARED click waveform gave every song identical percussion
        # constellations -> identical hashes -> 100K-row index buckets
        # (and a raw impulse's broadband floor hovers at amp_min packing
        # marginal maxima)
        omg = random.uniform(random.fold_in(ka, 1), (nck, 1),
                             minval=0.18, maxval=0.6)
        dec = random.uniform(random.fold_in(ka, 2), (nck, 1),
                             minval=25.0, maxval=60.0)
        clicks = jnp.exp(-tck[None, :] / dec) * jnp.sin(tck[None, :] * omg)
        audio = audio.at[hits[:, None]
                         + jnp.arange(441)[None, :]].add(amps * clicks)
        audio = audio + random.normal(kn, (N_GEN,)) * 0.01
        audio = audio / jnp.max(jnp.abs(audio)) * 0.8
        audio = jnp.round(audio[:N_SAMP] * 32767.0)
        return jnp.pad(audio, (0, BLEN - N_SAMP))

    @jax.jit
    def gen(sids):
        return jax.vmap(one_song)(sids)

    return gen


def main() -> None:
    import jax

    from shazam_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from jax import lax
    from shazam_tpu.api import SIA

    gen = _make_gen()

    @jax.jit
    def clip_of(sids, row, start):
        songs = gen(sids)
        c = lax.dynamic_slice(songs, (row, start), (1, int(CLIP_S * FS)))
        return c[0].astype(jnp.int16)

    def batch_sids(base):
        return jnp.asarray(
            np.arange(base, min(base + BATCH, N_SONGS), dtype=np.int32))

    reserve = int(os.environ.get(
        "CATALOG_RESERVE",
        1 << max(int(np.ceil(np.log2(N_SONGS * 13000))), 20)))
    # CATALOG_SPAN_ROWS: hold the index as bounded sorted spans
    # (SpannedDeviceStore) — on a 16 GB device required past ~150M
    # hashes, where a single buffer's capacity-doubled sort outgrows
    # the headroom (e.g. 1<<27 spans for the
    # reference's 436M-hash deployment, fingerprints_queries.sql:3)
    span_rows = int(os.environ.get("CATALOG_SPAN_ROWS", 0))
    # CATALOG_SAVE=prefix: persist the built index (prefix.idx.npz) and
    # its sqlite catalog (prefix.sqlite) so serving benches (serve_qps
    # SERVE_DB mode) and bench.py's real-index query headline reuse this
    # build instead of re-ingesting for 20 minutes.
    save_prefix = os.environ.get("CATALOG_SAVE")
    # CATALOG_LOAD=prefix: reuse a CATALOG_SAVE build (index npz +
    # sqlite catalog) instead of the ~20-min re-ingest — everything
    # downstream (sweeps, query packs, latency, QPS) runs unchanged
    # against the loaded index. N_SONGS/DURATION/STYLE must match the
    # build's (the sweep regenerates clips with the same generator).
    load_prefix = os.environ.get("CATALOG_LOAD")
    catalog_path = None
    if load_prefix:
        catalog_path = load_prefix + ".sqlite"
    elif save_prefix:
        catalog_path = save_prefix + ".sqlite"
        for p in (catalog_path, save_prefix + ".idx.npz"):
            if os.path.exists(p):
                os.remove(p)   # fresh deterministic build, no SHA resume
        os.makedirs(os.path.dirname(save_prefix) or ".", exist_ok=True)
    sia = SIA(device_resident=True, device_reserve_hashes=reserve,
              device_span_rows=span_rows, catalog_path=catalog_path)
    if load_prefix:
        t0 = time.time()
        # CATALOG_CONSOLIDATE=early on a load: build the stacked serving
        # layout straight from the snapshot — consolidate() of the live
        # store needs catalog + one column + copy transients of HBM,
        # which OOMs at 436M hashes; the stacked load never holds both
        # layouts (sweep + latency then exercise the stacked matcher)
        sia.load_index(
            load_prefix + ".idx.npz",
            stacked=bool(span_rows
                         and os.environ.get("CATALOG_CONSOLIDATE")))
        n_hashes = sia.index.n_hashes if sia.index is not None \
            else sia._dev_store.n_valid
        assert sia.catalog.counts()["n_songs"] == N_SONGS, \
            (sia.catalog.counts(), N_SONGS)
        print(f"loaded catalog: {N_SONGS} songs, {n_hashes} hashes "
              f"({time.time()-t0:.0f}s) from {load_prefix}", flush=True)
        run_catalog(sia, gen, clip_of, batch_sids, n_hashes, span_rows,
                    save_prefix if save_prefix else load_prefix)
        return
    t0 = time.time()
    for base in range(0, N_SONGS, BATCH):
        sids = batch_sids(base)
        names = [f"track{i:06d}" for i in np.asarray(sids)]
        stats = sia.ingest_device_batch(
            names, gen(sids), [N_SAMP] * len(names),
            song_peak_capacity=32768,
            # tail-append runs now, ONE global sort at the end: the
            # per-batch scatter merge is O(base)
            defer_sort=True,
        )
        if stats["overflowed"]:
            print("OVERFLOWED:", stats["overflowed"])
        if base % 256 == 0:
            print(f"ingested {base + len(names)}/{N_SONGS} "
                  f"({sia._live_n_hashes()} hashes, {time.time()-t0:.0f}s)",
                  flush=True)
    n_hashes = sia._live_n_hashes()
    t_f = time.time()
    store = sia._ensure_dev_store()
    store.finalize()
    jax.block_until_ready(store.spans[-1].cols if span_rows
                          else store.cols)
    print(f"catalog: {N_SONGS} songs x {DURATION:.0f}s, {n_hashes} hashes, "
          f"ingest {time.time()-t0:.0f}s "
          f"(final {n_hashes}-row sort {time.time()-t_f:.1f}s)", flush=True)

    # save BEFORE consolidating: the snapshot format is span-wise either
    # way, and saving from the stacked layout at 436M OOMs the chip
    # (span436_r5 try 1 — the per-span chunk downloads out of the
    # stacked columns allocate transients alongside the 8.6 GB stack)
    if save_prefix:
        t_s = time.time()
        sia.save_index(save_prefix + ".idx.npz")
        print(f"saved index+catalog -> {save_prefix}.idx.npz/.sqlite "
              f"({time.time()-t_s:.0f}s)", flush=True)

    # CATALOG_CONSOLIDATE=early: switch to the stacked serving layout
    # right after ingest (max free HBM) — sweep + latency then exercise
    # the vmapped stacked matcher end to end
    if span_rows and os.environ.get("CATALOG_CONSOLIDATE") == "early":
        t_c = time.time()
        store.consolidate()
        print(f"consolidated -> stacked ({store._stacked[0].shape}) "
              f"in {time.time()-t_c:.1f}s", flush=True)
    run_catalog(sia, gen, clip_of, batch_sids, n_hashes, span_rows,
                save_prefix)


def run_catalog(sia, gen, clip_of, batch_sids, n_hashes, span_rows,
                save_prefix):
    """Sweeps + query packs + latency + QPS against a ready index."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax

    store = sia._dev_store

    # bitwise check: clip_of must slice the same samples ingest saw
    row = np.asarray(gen(batch_sids(0)))[3]
    c0 = np.asarray(clip_of(batch_sids(0), jnp.int32(3), jnp.int32(123456)))
    print("clip/gen bitwise equal:",
          np.array_equal(row[123456 : 123456 + int(CLIP_S * FS)]
                         .astype(np.int16), c0), flush=True)

    # ---- accuracy sweep(s): N_CLIPS random clips, production API ------
    from shazam_tpu.audio.noise import (mix_at_snr, renormalize,
                                        white_noise_for_snr)

    noise_samples = None
    if NOISE_FILE:
        from shazam_tpu.audio.io import read as read_audio

        nch, nfs, _ = read_audio(NOISE_FILE)
        assert nfs == FS, (NOISE_FILE, nfs, FS)
        noise_samples = nch[0]

    fails = []
    for snr_db in (SNRS if N_CLIPS > 0 else []):   # CATALOG_CLIPS=0 =
        # build/save only, no accuracy sweep (used by the build jobs)
        rng = np.random.default_rng(42)
        correct = 0
        times = []
        if snr_db is not None:
            kind = NOISE_FILE or "AWGN"
            print(f"sweep with {kind} at {snr_db:.0f} dB SNR", flush=True)
        # with replacement when clips outnumber songs (e.g. the
        # reference's 300 x 5 s @ 100-song shape) — every clip still
        # gets an independent random start
        picks = rng.choice(N_SONGS, N_CLIPS, replace=N_CLIPS > N_SONGS)
        for i, sid in enumerate(picks):
            base = int(sid) // BATCH * BATCH
            a = int(rng.integers(0, N_SAMP - int(CLIP_S * FS)))
            clip = np.asarray(clip_of(batch_sids(base),
                                      jnp.int32(int(sid) - base),
                                      jnp.int32(a)))
            if os.environ.get("CATALOG_CHANNEL"):
                # synthetic acoustic loop (audio/channel.py) standing in
                # for the reference's speakers->mic rig, before noise
                from shazam_tpu.audio.channel import simulate_channel

                clip = simulate_channel(
                    clip.astype(np.int16), fs=FS,
                    rng=np.random.default_rng(7000 + i),
                    severity=float(os.environ.get(
                        "CATALOG_CHAN_SEVERITY", 1.0))).astype(np.float32)
            if snr_db is not None:
                # same recipe as bench/harness.py — renormalize, add
                # noise, then RESTORE int16 scale (the pipeline's
                # amp_min threshold assumes int16-scale samples)
                nrng = np.random.default_rng(1000 + i)
                if noise_samples is not None:
                    noisy = mix_at_snr(clip.astype(np.int16),
                                       noise_samples, snr_db, rng=nrng)
                else:
                    sig = renormalize(clip.astype(np.float32))
                    noisy = sig + white_noise_for_snr(sig, snr_db,
                                                      rng=nrng)
                clip = np.clip(noisy * 32767.0, -32768, 32767
                               ).astype(np.float32)
            t1 = time.time()
            out = sia.recognize_samples([clip], topn=2)
            times.append(time.time() - t1)
            if (out["results"]
                    and out["results"][0]["song_name"] == f"track{sid:06d}"):
                correct += 1
            else:
                r0 = out["results"][0] if out["results"] else {}
                fails.append((int(sid), a, r0.get("song_name"),
                              int(r0.get("hashes_matched_in_input", 0)),
                              clip if len(fails) < 10 else None))
                if snr_db is None:
                    print(f"  MISS sid {sid} start {a}: "
                          f"got {r0.get('song_name')} "
                          f"votes={r0.get('hashes_matched_in_input')} "
                          f"overflow={out.get('overflowed')}", flush=True)
            if (i + 1) % 100 == 0:
                print(f"sweep {i+1}/{N_CLIPS}: acc {correct/(i+1):.4f}, "
                      f"p50 api {np.median(times)*1000:.0f} ms", flush=True)
        acc = correct / N_CLIPS
        tag = "clean" if snr_db is None else f"{snr_db:.0f} dB SNR"
        print(f"ACCURACY [{tag}] {acc:.4f} over {N_CLIPS} x "
              f"{CLIP_S:.0f}s clips vs {n_hashes}-hash index; "
              f"api p50 {np.median(times)*1000:.0f} ms", flush=True)

    if os.environ.get("CATALOG_DEBUG") and fails:
        dbg = {"fail_sids": np.array([f[0] for f in fails]),
               "fail_starts": np.array([f[1] for f in fails])}
        for j, f in enumerate(fails[:10]):
            if f[4] is not None:
                dbg[f"clip{j}"] = f[4]
        ix = sia.index  # chunked device->host download
        dbg.update(key_hi=ix.key_hi, key_lo=ix.key_lo, key_ex=ix.key_ex,
                   song_id=ix.song_id, offset=ix.offset)
        dump = os.path.join(tempfile.gettempdir(), "catalog_debug.npz")
        np.savez(dump, **dbg)
        print(f"debug dump: {len(fails)} fails, index "
              f"{ix.n_hashes} rows -> {dump}", flush=True)

    if save_prefix:
        # Real query packs for bench.py's query headline: fingerprints of
        # actual 15 s clips from this catalog, prepared exactly like the
        # serving path — so bench.py's query latency is measured
        # against real keys hitting a real index, not synthetic ones.
        from shazam_tpu.api import _batch_fingerprints, _bucket_len
        from shazam_tpu.match.prepare import prepare_query
        from shazam_tpu.ops.fingerprint import fingerprint_batch

        if N_CLIPS <= 0:
            # build-only mode (CATALOG_CLIPS=0) never ran the sweep
            # that defines picks — draw the query-pack songs directly
            picks = np.random.default_rng(42).choice(
                N_SONGS, min(8, N_SONGS), replace=False)
        qn = min(8, len(picks))
        qclips = [np.asarray(clip_of(
            batch_sids(int(picks[j]) // BATCH * BATCH),
            jnp.int32(int(picks[j]) % BATCH), jnp.int32(FS * (j + 1))))
            for j in range(qn)]
        blen_q = max(_bucket_len(len(c)) for c in qclips)
        cbq = np.zeros((qn, blen_q), np.float32)
        nvq = np.full(qn, len(qclips[0]), np.int32)
        for i, c in enumerate(qclips):
            cbq[i, : len(c)] = c
        cfgq = sia.config
        fpq = jax.device_get(fingerprint_batch(
            jnp.asarray(cbq), jnp.asarray(nvq),
            fs=cfgq.sample_rate, wsize=cfgq.window_size, hop=cfgq.hop,
            amp_min=cfgq.amp_min, radius=cfgq.peak_neighborhood_size,
            fan_value=cfgq.fan_value, min_dt=cfgq.min_hash_time_delta,
            max_dt=cfgq.max_hash_time_delta,
            peak_capacity=cfgq.peak_capacity))
        packs = [prepare_query([_batch_fingerprints(fpq, i)], pad_to=4096)
                 for i in range(qn)]
        np.savez(save_prefix + ".queries.npz",
                 hi=np.stack([p.hi for p in packs]),
                 lo=np.stack([p.lo for p in packs]),
                 ex=np.stack([p.ex for p in packs]),
                 t=np.stack([p.t for p in packs]),
                 valid=np.stack([p.valid for p in packs]),
                 first=np.stack([p.first for p in packs]),
                 n_songs=np.int64(N_SONGS),
                 clip_samples=np.int64(int(CLIP_S * FS)))
        print(f"saved {qn} real query packs -> "
              f"{save_prefix}.queries.npz", flush=True)

    # ---- device-honest single-dispatch latency on this real index ----
    from shazam_tpu.match.ondevice import (recognize_on_device,
                                           recognize_on_device_spanned)

    dev = sia._ensure_device_index()
    # spanned stacked stores serve through the SPAN unique-view (the
    # search table the API uses — api._span_uview); measuring without
    # it would time bucket-head descents the API no longer uses
    uview, usteps = (sia._span_uview() if span_rows
                     else sia._ensure_uview(dev))
    head = (None if (span_rows and uview is not None)
            else (sia._ensure_heads(dev) if span_rows
                  else sia._ensure_head(dev)))
    if uview is None and not span_rows and save_prefix:
        # device-resident build: the API declines (no host columns), but
        # the snapshot just saved/loaded has them — build the view from
        # the npz (row order identical to the device columns by
        # construction, so the CDF offsets line up). run_catalog's
        # save_prefix is the snapshot prefix for BOTH save and load runs
        # (main passes CATALOG_SAVE or falls back to CATALOG_LOAD).
        pfx = save_prefix
        if os.path.exists(pfx + ".idx.npz"):
            from shazam_tpu.index.search import build_unique_view

            with np.load(pfx + ".idx.npz") as z:
                uview, usteps = build_unique_view(
                    z["key_hi"], z["key_lo"], z["key_ex"])
    delta_min, delta_range = sia._delta_params_for(int(CLIP_S * FS))
    lat_sid = int(picks[0])
    clip = np.asarray(clip_of(batch_sids(lat_sid // BATCH * BATCH),
                              jnp.int32(lat_sid % BATCH), jnp.int32(FS)))
    cblen = -(-len(clip) // (1 << 18)) * (1 << 18)
    padded = np.zeros(cblen, np.float32)
    padded[: len(clip)] = clip
    # measure the PRODUCTION single-dispatch program: on big sparse
    # indexes the decided-first policy runs the single-dispatch program
    # at the decide tier (api.recognize_clip), not the fast tier
    lat_cap = sia.config.match_capacity_fast
    big_lat = (N_SONGS * delta_range > sia.config.sparse_vote_threshold
               and n_hashes >= sia.config.bounds_probe_min_rows)
    pol_lat = sia.config.escalation_policy
    if big_lat and (pol_lat == "decide"
                    or (pol_lat == "auto"
                        and sia.config.decision_escalation)):
        lat_cap = sia._decide_cap(sia._match_tiers())
    kw = dict(
        n_songs=N_SONGS, delta_min=delta_min, delta_range=delta_range,
        match_capacity=lat_cap, topn=2,
        offset_stride=sia._offset_stride, peak_capacity=8192,
        query_capacity=4096,
        rank_candidates=sia.config.rank_candidates,
        vote_rank=sia._rank_for(lat_cap),
        expand_runs=sia.config.expand_block_runs,
    )
    if not span_rows:
        kw.update(
            sparse_threshold=sia.config.sparse_vote_threshold,
            expand_block=sia._eblk_for_cap(
                sia._expand_block_for(dev), lat_cap))
    else:
        kw.update(expand_block=sia._eblk_for_cap(
            sia._expand_block_for_spanned(dev), lat_cap))

    def make_loop(kw_loop):
        @functools.partial(jax.jit, static_argnames=("k", "u_steps"))
        def loop(x, nv, dev_cols, hd, uv, k, u_steps=0):
            # dev_cols as operands: a closed-over index would be traced
            # as a 536 MB constant
            def body(i, acc):
                if span_rows:
                    out = recognize_on_device_spanned(
                        jnp.roll(x, i, axis=1) + acc * 1e-30, nv,
                        dev_cols, heads=hd, uviews=uv,
                        u_steps=u_steps, **kw_loop)
                else:
                    out = recognize_on_device(
                        jnp.roll(x, i, axis=1) + acc * 1e-30, nv,
                        dev_cols, head=hd, uview=uv, u_steps=u_steps,
                        **kw_loop)
                return acc + sum(jnp.sum(l.astype(jnp.float32))
                                 for l in jax.tree_util.tree_leaves(out))
            return lax.fori_loop(0, k, body, jnp.float32(0))
        return loop

    loop = make_loop(kw)
    x0 = jnp.asarray(padded)[None, :]
    nv0 = jnp.asarray([len(clip)], np.int32)

    def measure(dev_cols, hd, tag, uv=None, us=0, fn=None):
        fn = fn or loop
        res = {}
        for k in (1, 9):
            float(fn(x0, nv0, dev_cols, hd, uv, k, u_steps=us))
            best = []
            for _ in range(3):
                t1 = time.time()
                float(fn(x0, nv0, dev_cols, hd, uv, k, u_steps=us))
                best.append(time.time() - t1)
            res[k] = min(best)
        ms = (res[9] - res[1]) / 8 * 1000
        print(f"recognize_clip device{tag}: {ms:.2f} ms per "
              f"{CLIP_S:.0f} s clip "
              f"(q_cap 4096) vs {n_hashes}-hash real index", flush=True)

    if not os.environ.get("CATALOG_SKIP_LATENCY"):
        if not span_rows and uview is not None:
            measure(dev, head, " [head]")          # A/B: head vs uview
            measure(dev, head, " [uniq]", uview, usteps)
        else:
            measure(dev, head,
                    " [consolidated]" if (span_rows and store.is_stacked)
                    else "", uview, usteps)
        if big_lat and lat_cap < sia.config.decide_adapt_max:
            # heavy-skew corpora CONVERGE the self-tuning decide tier
            # upward (config.decide_adapt_window) — also measure the
            # converged ceiling so the production steady state for
            # such catalogs is on record
            hi_cap = next((c for c in sia._match_tiers()
                           if c >= sia.config.decide_adapt_max),
                          sia.config.decide_adapt_max)
            kw_hi = dict(kw, match_capacity=hi_cap,
                         vote_rank=sia._rank_for(hi_cap))
            measure(dev, head, f" [decide tier {hi_cap}]", uview,
                    usteps, fn=make_loop(kw_hi))
        if span_rows and not store.is_stacked \
                and os.environ.get("CATALOG_CONSOLIDATE"):
            # stacked serving layout: one vmapped search over the spans
            store.consolidate()
            dev2 = sia._ensure_device_index()
            uv2, us2 = sia._span_uview()
            heads2 = None if uv2 is not None else sia._ensure_heads(dev2)
            measure(dev2, heads2, " [consolidated]", uv2, us2)

    # ---- CATALOG_QPS=4,16: batched serving throughput on this real ----
    # index (match_queries_batched[_spanned] chained-loop, real clips)
    if os.environ.get("CATALOG_QPS"):
        from shazam_tpu.match.batched import (match_queries_batched,
                                              match_queries_batched_spanned)

        dev = sia._ensure_device_index()
        uv, us = ((sia._span_uview() if span_rows else (uview, usteps)))
        hd = (None if (span_rows and uv is not None)
              else (sia._ensure_heads(dev) if span_rows
                    else sia._ensure_head(dev)))
        # mirror the serving dispatch's program (api.match_prepared_
        # batch base dispatch): decide tier, scan rank, blocked
        # expansion with the run budget
        q_cap_srv = sia._decide_cap(sia._match_tiers())
        q_eblk = (sia._expand_block_for_spanned(dev) if span_rows
                  else sia._expand_block_for(dev))
        qkw = dict(
            n_songs=N_SONGS, delta_min=delta_min, delta_range=delta_range,
            match_capacity=q_cap_srv, topn=2,
            offset_stride=sia._offset_stride,
            vote_rank=sia._rank_for(q_cap_srv)
            if sia._rank_for(q_cap_srv) != "pruned" else "sort",
            expand_block=sia._eblk_for_cap(q_eblk, q_cap_srv),
            expand_runs=sia.config.expand_block_runs,
        )
        for bq in (int(b) for b in os.environ["CATALOG_QPS"].split(",")):
            # fingerprint bq real clips through the production path once
            clips = []
            for j in range(bq):
                sid = int(picks[j % len(picks)])
                clips.append(np.asarray(clip_of(
                    batch_sids(sid // BATCH * BATCH),
                    jnp.int32(sid % BATCH), jnp.int32(FS + j))))
            from shazam_tpu.api import _batch_fingerprints, _bucket_len
            from shazam_tpu.match.prepare import prepare_query
            from shazam_tpu.ops.fingerprint import fingerprint_batch

            blen = max(_bucket_len(len(c)) for c in clips)
            cb = np.zeros((bq, blen), np.float32)
            nv = np.zeros(bq, np.int32)
            for i, c in enumerate(clips):
                cb[i, : len(c)] = c
                nv[i] = len(c)
            cfg = sia.config
            fp = jax.device_get(fingerprint_batch(
                jnp.asarray(cb), jnp.asarray(nv),
                fs=cfg.sample_rate, wsize=cfg.window_size, hop=cfg.hop,
                amp_min=cfg.amp_min, radius=cfg.peak_neighborhood_size,
                fan_value=cfg.fan_value, min_dt=cfg.min_hash_time_delta,
                max_dt=cfg.max_hash_time_delta,
                peak_capacity=cfg.peak_capacity))
            qs = [prepare_query([_batch_fingerprints(fp, i)])
                  for i in range(bq)]
            q_cap = max(len(q.hi) for q in qs)
            stack = {
                name: np.stack([
                    np.pad(getattr(q, name), (0, q_cap - len(q.hi)))
                    for q in qs])
                for name in ("hi", "lo", "ex", "t", "valid", "first")
            }
            qa = tuple(jnp.asarray(stack[n]) for n in
                       ("hi", "lo", "ex", "t", "valid", "first"))

            @functools.partial(jax.jit, static_argnames=("k", "u_steps"))
            def qloop(qa, dev_cols, hd, uv, k, u_steps=0):
                def body(i, acc):
                    # uint32(acc*1e-30) == 0 at runtime but makes each
                    # iteration depend on the last (no overlap, no DCE)
                    bump = (acc * 1e-30).astype(jnp.uint32)
                    args = (qa[0] ^ bump,) + qa[1:]
                    if span_rows:
                        out, _ = match_queries_batched_spanned(
                            dev_cols, *args, heads=hd, uviews=uv,
                            u_steps=u_steps, **qkw)
                    else:
                        out = match_queries_batched(
                            dev_cols, *args, head=hd, uview=uv,
                            u_steps=u_steps, **qkw)
                    return acc + sum(jnp.sum(l.astype(jnp.float32))
                                     for l in jax.tree_util.tree_leaves(out))
                return lax.fori_loop(0, k, body, jnp.float32(0))

            res = {}
            for k in (1, 9):
                float(qloop(qa, dev, hd, uv, k, u_steps=us))
                best = []
                for _ in range(3):
                    t1 = time.time()
                    float(qloop(qa, dev, hd, uv, k, u_steps=us))
                    best.append(time.time() - t1)
                res[k] = min(best)
            ms = (res[9] - res[1]) / 8 * 1000
            print(f"batched serving [{'stacked' if span_rows else 'flat'}]"
                  f" bq={bq}: {ms:.1f} ms/batch, "
                  f"{bq / ms * 1000:.0f} queries/s/chip "
                  f"(q_cap {q_cap}) vs {n_hashes}-hash real index",
                  flush=True)


if __name__ == "__main__":
    main()

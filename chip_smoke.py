"""Run the system once on an NVIDIA GPU through the entry points a user calls.

    python chip_smoke.py                  # one card, the main path
    python chip_smoke.py --chips 4        # only the four-card path
    python chip_smoke.py --tracks 7986    # the production index instead

One card: oracle parity of the fingerprint pipeline at full width, ingest
of the 2,714-track benchmark catalog (210 s tracks from the seeded device
music generator) into a device-resident index, recognition of 64 clips
cut from it (solo and batched, clean and at 0 dB AWGN), one device-engine
stream session, and the HTTP server answering 16 concurrent requests.
Four cards: the sharded fingerprint, sequence-parallel fingerprint and
both sharded match regimes, each against its single-card answer.

Everything runs in this one process. The script exits non-zero, before it
prints any result, when JAX's first device is not a GPU, and any failed
check ends the run with a non-zero exit. The last line of standard output
is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import http.client
import io
import json
import os
import sys
import tempfile
import time
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from shazam_tpu.runtime import card_line, enable_compile_cache, require_gpu  # noqa: E402

FS = 44100
BENCHMARK_TRACKS = 2714      # the reference's benchmark catalog (BASELINE.md)
# gated at their use sites; the card's machine need not have them
OPTIONAL_PACKAGES = ("pandas", "sklearn", "matplotlib", "pyaudio")


class SmokeFailure(AssertionError):
    """A check of the smoke run failed; the run exits non-zero."""


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one run. The defaults are the full-width run on the card;
    the tests use ``Sizes.tiny()`` on the CPU."""

    tracks: int = BENCHMARK_TRACKS
    track_s: float = 210.0
    batch: int = 16
    clips: int = 64
    clip_s: float = 15.0
    parity_s: float = 30.0
    sha_messages: int = 4096
    serve_requests: int = 16
    serve_max_batch: int = 16
    timing_batch: int = 16
    timing_s: float = 30.0
    seq_songs: int = 8          # four-card path: rows of the sharded batch

    @classmethod
    def tiny(cls) -> "Sizes":
        return cls(tracks=6, track_s=12.0, batch=4, clips=3, clip_s=5.0,
                   parity_s=4.0, sha_messages=64, serve_requests=2,
                   serve_max_batch=2, timing_batch=2, timing_s=4.0,
                   seq_songs=4)


def _fp_kwargs(cfg, peak_capacity):
    return dict(fs=cfg.sample_rate, wsize=cfg.window_size, hop=cfg.hop,
                amp_min=cfg.amp_min, radius=cfg.peak_neighborhood_size,
                fan_value=cfg.fan_value, min_dt=cfg.min_hash_time_delta,
                max_dt=cfg.max_hash_time_delta, peak_capacity=peak_capacity)


def _bucket(n: int) -> int:
    return -(-n // (1 << 18)) * (1 << 18)


def _top(result):
    rs = result.get("results") or []
    return rs[0] if rs else {}


# --------------------------------------------------------------------- #
# phase 1: the device
# --------------------------------------------------------------------- #
def phase_device(n_chips: int):
    import jax

    dev = require_gpu()
    devices = jax.devices()
    check(len(devices) >= n_chips,
          f"{n_chips} cards asked for, JAX sees {len(devices)}")
    card = card_line().replace("\n", "; ")
    log(f"card (name, power limit): {card}")
    log(f"device_kind={dev.device_kind} devices={len(devices)} "
        f"jax={jax.__version__}")
    return dev, card


# --------------------------------------------------------------------- #
# phase 2: oracle parity at full width
# --------------------------------------------------------------------- #
def phase_parity(sz: Sizes, seed: int = 2026) -> dict:
    import jax
    import jax.numpy as jnp

    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.config import DEFAULT_CONFIG as cfg
    from shazam_tpu.ops.fingerprint import (Fingerprints, fingerprint_batch,
                                            fingerprint_to_hex_pairs)
    from shazam_tpu.ops.peaks import peak_mask
    from shazam_tpu.ops.sha1 import sha1_triples
    from shazam_tpu.ops.spectrogram import spectrogram_db
    from tests.oracle import oracle_fingerprint, oracle_peaks, oracle_spectrogram

    n = int(sz.parity_s * FS)
    songs = [synth_song(i, duration_s=sz.parity_s, seed=seed) for i in range(2)]
    mat = np.zeros((2, _bucket(n)), np.float32)
    for i, s in enumerate(songs):
        mat[i, :n] = s
    cap = 16384
    fp = jax.device_get(fingerprint_batch(
        jnp.asarray(mat), jnp.asarray([n, n], np.int32),
        **_fp_kwargs(cfg, cap)))
    def spec_err(samples, floor_db):
        ref = oracle_spectrogram(samples)
        ours = np.asarray(spectrogram_db(jnp.asarray(
            np.asarray(samples, np.float32))))
        check(ours.shape == ref.shape,
              f"spectrogram shape {ours.shape} != oracle {ref.shape}")
        live = ref > floor_db
        return ref, float(np.max(np.abs(ours[live] - ref[live])))

    # the bound of tests/test_dsp_parity.py on its own clip: 0.15 dB
    # wherever the oracle reads above -80 dB
    _, err = spec_err(synth_song(7, duration_s=3.0, seed=99), -80.0)
    check(err <= 0.15, f"test clip: dB spectrogram off by {err} dB")
    out = {"spec_test_clip_db": err, "spec_above_amp_min_db": 0.0,
           "spec_above_m80_db": 0.0, "jaccard_min": 1.0}
    for i, s in enumerate(songs):
        # 30 s songs: bins ~100 dB and more below their frame's peak lie
        # under float32's resolution in any FFT, so the -80 dB floor is
        # reported, not gated; every bin the peak picker can accept
        # (above amp_min) is held to the same 0.15 dB
        ref, err = spec_err(s, float(cfg.amp_min))
        out["spec_above_amp_min_db"] = max(out["spec_above_amp_min_db"], err)
        check(err <= 0.15, f"song {i}: dB spectrogram above amp_min off by "
                           f"{err} dB")
        out["spec_above_m80_db"] = max(out["spec_above_m80_db"],
                                       spec_err(s, -80.0)[1])

        ref32 = ref.astype(np.float32)
        mask = np.asarray(peak_mask(jnp.asarray(ref32), float(cfg.amp_min),
                                    radius=cfg.peak_neighborhood_size))
        ref_mask = np.zeros(ref.shape, bool)
        for f, t in oracle_peaks(ref32.astype(np.float64),
                                 amp_min=cfg.amp_min,
                                 neighborhood=cfg.peak_neighborhood_size):
            ref_mask[f, t] = True
        check(np.array_equal(mask, ref_mask),
              f"song {i}: peak mask differs in "
              f"{int(np.sum(mask != ref_mask))} cells")

        one = Fingerprints(*(np.asarray(a)[i] for a in fp))
        check(int(one.n_peaks) <= cap, f"song {i}: peak capacity overflow")
        ours_h = set(fingerprint_to_hex_pairs(one))
        ref_h = set(oracle_fingerprint(s))
        jac = len(ours_h & ref_h) / max(len(ours_h | ref_h), 1)
        out["jaccard_min"] = min(out["jaccard_min"], jac)
        check(jac > 0.98, f"song {i}: hash-set jaccard {jac}")

    rng = np.random.default_rng(seed)
    f1 = rng.integers(0, 2049, sz.sha_messages).astype(np.uint32)
    f2 = rng.integers(0, 2049, sz.sha_messages).astype(np.uint32)
    dt = rng.integers(0, 201, sz.sha_messages).astype(np.uint32)
    words = np.stack([np.asarray(w) for w in jax.device_get(
        sha1_triples(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(dt)))], 1)
    got = [b"".join(int(v).to_bytes(4, "big") for v in row) for row in words]
    want = [hashlib.sha1(f"{a}|{b}|{c}".encode()).digest()
            for a, b, c in zip(f1, f2, dt)]
    n_bad = sum(g != w for g, w in zip(got, want))
    check(n_bad == 0, f"SHA-1 lanes: {n_bad} of {len(want)} digests differ")
    out["sha1_messages"] = len(want)
    out["matmul_precision"] = str(jax.config.jax_default_matmul_precision)
    log(f"parity: dB spectrogram max |err| {out['spec_test_clip_db']:.4f} "
        f"dB on the test clip above -80 dB (bound 0.15); "
        f"{sz.parity_s:.0f} s songs "
        f"{out['spec_above_amp_min_db']:.6f} dB above amp_min (bound 0.15), "
        f"{out['spec_above_m80_db']:.4f} dB above -80 dB (reported); peak "
        f"masks equal; hash-set jaccard min {out['jaccard_min']:.5f} "
        f"(bound 0.98); SHA-1 bit-exact on {len(want)} messages")
    log(f"precision: the spectrogram's FFT is jnp.fft.rfft in float32 "
        f"(cuFFT on the GPU); the fingerprint pipeline has no matrix "
        f"product, so no TF32 enters it; default matmul precision "
        f"{out['matmul_precision']}")
    return out


# --------------------------------------------------------------------- #
# phase 3: ingest at the benchmark catalog's scale
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Catalog:
    sia: object
    clips: list            # int16 numpy clips, cut on the device
    clip_names: list       # the song each clip was cut from
    n_hashes: int
    seconds: float


def _track_name(sid: int) -> str:
    return f"track{sid:06d}"


def phase_ingest(sz: Sizes, seed: int = 77) -> Catalog:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from shazam_tpu.api import SIA
    from shazam_tpu.audio.synth_device import make_music_gen

    gen = make_music_gen(sz.track_s, fs=FS, seed=seed)
    n_samp = gen.n_samp
    clip_len = int(sz.clip_s * FS)
    rng = np.random.default_rng(seed)
    clip_sids = rng.choice(sz.tracks, size=min(sz.clips, sz.tracks),
                           replace=False)
    clip_start = dict(zip(clip_sids.tolist(), rng.integers(
        0, n_samp - clip_len, len(clip_sids)).tolist()))

    @jax.jit
    def cut(songs, row, start):
        return lax.dynamic_slice(songs, (row, start), (1, clip_len))[0]

    reserve = 1 << max(int(np.ceil(np.log2(sz.tracks * 13000))), 20)
    sia = SIA(device_resident=True, device_reserve_hashes=reserve)
    clips, names = {}, {}
    t0 = time.perf_counter()
    for base in range(0, sz.tracks, sz.batch):
        real = list(range(base, min(base + sz.batch, sz.tracks)))
        # a short last batch repeats its last track: rows with one name
        # are channels of one song, whose hash sets are unioned, so the
        # index is unchanged and every batch keeps one compiled shape
        sids = real + [real[-1]] * (sz.batch - len(real))
        songs = gen(jnp.asarray(sids, jnp.int32))
        if base == 0:
            again = gen(jnp.asarray(sids, jnp.int32))
            check(bool(jnp.array_equal(songs, again)),
                  "device music generator is not bit-identical across "
                  "two calls")
        for row, sid in enumerate(real):
            if sid in clip_start:
                clips[sid] = cut(songs, row, clip_start[sid])
                names[sid] = _track_name(sid)
        stats = sia.ingest_device_batch(
            [_track_name(s) for s in sids], songs, [n_samp] * len(sids),
            song_peak_capacity=32768, defer_sort=True)
        check(not stats["overflowed"], f"overflowed: {stats['overflowed']}")
        check(stats["ingested"] == len(real),
              f"batch at {base}: ingested {stats['ingested']} of {len(real)}")
    store = sia._ensure_dev_store()
    store.finalize()
    jax.block_until_ready(store.cols)
    seconds = time.perf_counter() - t0
    n_hashes = int(sia._live_n_hashes())
    check(sia.catalog.counts()["n_songs"] == sz.tracks,
          f"catalog holds {sia.catalog.counts()} songs, not {sz.tracks}")
    check(n_hashes > 0, "empty index")
    mem = jax.devices()[0].memory_stats() or {}
    log(f"ingest: {sz.tracks} tracks x {sz.track_s:.0f} s, {n_hashes} "
        f"hashes in {seconds:.2f} s (generator + fingerprint + sorted "
        f"runs + final sort, compiles included), peak_bytes_in_use "
        f"{mem.get('peak_bytes_in_use', 'not reported')}")
    order = sorted(clips)
    return Catalog(
        sia=sia,
        clips=[np.asarray(clips[s]).astype(np.int16) for s in order],
        clip_names=[names[s] for s in order],
        n_hashes=n_hashes, seconds=seconds)


def phase_host_ingest(sz: Sizes, seed: int = 11) -> dict:
    """A small catalog through the host paths: ``ingest_arrays`` and
    ``ingest_directory`` (which reads WAV files with the C++ loader when
    it builds)."""
    from shazam_tpu import native
    from shazam_tpu.api import SIA
    from shazam_tpu.audio.io import write_wav
    from shazam_tpu.audio.synth import synth_song

    secs = min(sz.track_s, 20.0)
    songs = [synth_song(i, duration_s=secs, seed=seed) for i in range(4)]
    sia = SIA()
    st = sia.ingest_arrays([(f"arr{i}", songs[i]) for i in range(2)])
    check(st["ingested"] == 2, f"ingest_arrays: {st}")
    with tempfile.TemporaryDirectory() as d:
        for i in range(2, 4):
            write_wav(os.path.join(d, f"wav{i}.wav"), songs[i], FS)
        st = sia.ingest_directory(d)
    check(st["ingested"] == 2, f"ingest_directory: {st}")
    n = int(min(sz.clip_s, secs / 2) * FS)
    for i, name in ((1, "arr1"), (3, "wav3")):
        top = _top(sia.recognize_samples([songs[i][FS: FS + n]]))
        check(top.get("song_name") == name,
              f"host-path clip of {name} matched {top.get('song_name')}")
    loader = native.available()
    log(f"host ingest: 4 songs via ingest_arrays + ingest_directory "
        f"(C++ loader {'built' if loader else 'unavailable'}), "
        f"{sia.index.n_hashes} hashes, clips recognized")
    return {"native_loader": loader}


# --------------------------------------------------------------------- #
# phase 4: recognition
# --------------------------------------------------------------------- #
def _awgn(clip: np.ndarray, snr_db: float, rng) -> np.ndarray:
    x = clip.astype(np.float64)
    noise_pow = np.mean(x * x) / (10.0 ** (snr_db / 10.0))
    return (x + rng.normal(0.0, np.sqrt(noise_pow), x.shape)).astype(
        np.float32)


def phase_recognize(cat: Catalog, seed: int = 5) -> dict:
    sia = cat.sia
    for clip, name in zip(cat.clips, cat.clip_names):
        top = _top(sia.recognize_clip(clip))
        check(top.get("song_name") == name,
              f"recognize_clip: clip of {name} matched {top.get('song_name')}")
    batch = sia.recognize_batch(cat.clips)
    for res, name in zip(batch, cat.clip_names):
        check(_top(res).get("song_name") == name,
              f"recognize_batch: clip of {name} matched "
              f"{_top(res).get('song_name')}")
    rng = np.random.default_rng(seed)
    noisy = [_awgn(c, 0.0, rng) for c in cat.clips]
    hits = sum(_top(r).get("song_name") == n
               for r, n in zip(sia.recognize_batch(noisy), cat.clip_names))
    acc = hits / len(noisy)
    log(f"recognize: {len(cat.clips)} clean clips top-1 their song through "
        f"recognize_clip and recognize_batch; 0 dB AWGN accuracy "
        f"{acc:.4f} ({hits}/{len(noisy)}, reported, not gated)")
    return {"clean": 1.0, "awgn0": acc}


# --------------------------------------------------------------------- #
# phase 5: one device-engine stream session
# --------------------------------------------------------------------- #
def phase_stream(cat: Catalog) -> dict:
    from shazam_tpu.stream import StreamRecognizer

    clip, name = cat.clips[0], cat.clip_names[0]
    sr = StreamRecognizer(cat.sia, channels=1,
                          window_seconds=len(clip) / FS, engine="device")
    for chunk in np.array_split(clip, 5):
        sr.feed(chunk)
    top = _top(sr.recognize())
    check(top.get("song_name") == name,
          f"stream of {name} matched {top.get('song_name')}")
    log(f"stream: device engine, 5 chunks, top-1 {name}")
    return {"song": name}


# --------------------------------------------------------------------- #
# phase 6: the HTTP server
# --------------------------------------------------------------------- #
def _wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(FS)
        wf.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def _http(port: int, method: str, path: str, body: bytes = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "audio/wav"} if body else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_serve(cat: Catalog, sz: Sizes) -> dict:
    from shazam_tpu import serve

    serve.warmup(cat.sia, seconds=sz.clip_s, max_batch=sz.serve_max_batch)
    srv = serve.RecognitionServer(cat.sia, host="127.0.0.1", port=0,
                                  max_batch=sz.serve_max_batch)
    srv.start_background()
    try:
        picks = [i % len(cat.clips) for i in range(sz.serve_requests)]
        with concurrent.futures.ThreadPoolExecutor(len(picks)) as ex:
            futs = [ex.submit(_http, srv.port, "POST", "/recognize",
                              _wav_bytes(cat.clips[i])) for i in picks]
            replies = [f.result() for f in futs]
        for (status, body), i in zip(replies, picks):
            check(status == 200, f"/recognize answered {status}: {body}")
            got = _top(body).get("song_name")
            check(got == cat.clip_names[i],
                  f"/recognize: clip of {cat.clip_names[i]} matched {got}")
        status, stats = _http(srv.port, "GET", "/stats")
        check(status == 200, f"/stats answered {status}")
    finally:
        srv.close()
    log(f"serve: {len(picks)} concurrent POST /recognize answered 200 with "
        f"the right top-1; /stats: {json.dumps(stats, sort_keys=True)}")
    return stats


# --------------------------------------------------------------------- #
# phase 7: first timings (readings, not claims)
# --------------------------------------------------------------------- #
def _median_seconds(fn, reps: int = 5) -> float:
    fn()                                   # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_timings(cat: Catalog, sz: Sizes, card: str) -> dict:
    import jax
    import jax.numpy as jnp

    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.config import DEFAULT_CONFIG as cfg
    from shazam_tpu.ops.fingerprint import fingerprint_batch

    n = int(sz.timing_s * FS)
    mat = np.zeros((sz.timing_batch, _bucket(n)), np.float32)
    for i in range(sz.timing_batch):
        mat[i, :n] = synth_song(i, duration_s=sz.timing_s, seed=5)
    x = jnp.asarray(mat)
    nv = jnp.asarray(np.full(sz.timing_batch, n, np.int32))
    kw = _fp_kwargs(cfg, cfg.peak_capacity)
    t_fp = _median_seconds(
        lambda: jax.block_until_ready(fingerprint_batch(x, nv, **kw)))
    clip = cat.clips[0]
    t_clip = _median_seconds(lambda: cat.sia.recognize_clip(clip))
    log(f"timing [{card}]: fingerprint_batch {sz.timing_batch} x "
        f"{sz.timing_s:.0f} s median {t_fp * 1e3:.3f} ms; recognize_clip "
        f"({sz.clip_s:.0f} s clip, {cat.n_hashes}-hash index) median "
        f"{t_clip * 1e3:.3f} ms (host clock, ends in a device sync; first "
        f"readings, not claims)")
    return {"fingerprint_batch_s": t_fp, "recognize_clip_s": t_clip}


def run_one_card(sz: Sizes, card: str) -> dict:
    if sz.tracks != BENCHMARK_TRACKS:
        log(f"catalog size: {sz.tracks} tracks, not the benchmark "
            f"catalog's {BENCHMARK_TRACKS}")
    out = {"parity": phase_parity(sz)}
    cat = phase_ingest(sz)
    out["ingest"] = {"tracks": sz.tracks, "hashes": cat.n_hashes,
                     "seconds": cat.seconds}
    out["host_ingest"] = phase_host_ingest(sz)
    out["recognize"] = phase_recognize(cat)
    out["stream"] = phase_stream(cat)
    out["serve"] = phase_serve(cat, sz)
    out["timings"] = phase_timings(cat, sz, card)
    return out


# --------------------------------------------------------------------- #
# the four-card path
# --------------------------------------------------------------------- #
_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "all-to-all", "reduce-scatter")


def _collectives(fn, *args) -> dict:
    """Collective operations in the compiled program of ``fn(*args)``."""
    import re

    import jax

    txt = jax.jit(fn).lower(*args).compile().as_text()
    counts = {op: len(re.findall(rf"\b{op}(?:-start)?\(", txt))
              for op in _COLLECTIVES}
    return {k: v for k, v in counts.items() if v}


def _match_program(sc, q_frames: int = 1024):
    """``sc``'s match dispatch with the index shards and head as
    arguments (as closures they would be compiled in as constants)."""
    import copy

    def fn(shards, head, *q):
        view = copy.copy(sc)
        view._shards, view._head = shards, head
        return view._match_once(q, 2, -q_frames,
                                sc._delta_range_for(q_frames),
                                sc.config.match_capacity)
    return fn


def _spread_over(arr, n_dev: int) -> bool:
    """True when ``arr`` is split over ``n_dev`` devices, none whole."""
    shards = arr.addressable_shards
    devs = {s.device for s in shards}
    return (len(devs) == n_dev
            and all(s.data.size * n_dev == arr.size for s in shards))


def run_four_cards(sz: Sizes, n_dev: int = 4) -> dict:
    import jax
    import jax.numpy as jnp

    from shazam_tpu.audio.synth_device import make_music_gen
    from shazam_tpu.config import DEFAULT_CONFIG as cfg
    from shazam_tpu.ops.fingerprint import fingerprint_batch
    from shazam_tpu.parallel.mesh import make_mesh
    from shazam_tpu.parallel.sequence import sequence_parallel_fingerprint
    from shazam_tpu.parallel.serving import ShardedCatalog, ShardedRecognizer
    from shazam_tpu.parallel.sharded import sharded_ingest_step

    mesh = make_mesh(n_dev)
    check(list(mesh.devices.flat) == jax.devices()[:n_dev],
          "mesh is not the first devices")
    cat = phase_ingest(sz)
    host_index = cat.sia.index
    out = {"hashes": cat.n_hashes}
    cap = 32768
    kw = _fp_kwargs(cfg, cap)

    # 1. data-parallel fingerprints == single-card fingerprints
    gen = make_music_gen(sz.track_s, fs=FS)
    sids = jnp.arange(sz.seq_songs, dtype=jnp.int32)
    songs = np.asarray(gen(sids))
    nv = np.full(sz.seq_songs, gen.n_samp, np.int32)
    one = jax.device_get(fingerprint_batch(
        jax.device_put(songs, jax.devices()[0]),
        jax.device_put(nv, jax.devices()[0]), **kw))
    dp = jax.device_get(sharded_ingest_step(mesh, jnp.asarray(songs),
                                            jnp.asarray(nv), **kw))
    for field, a, b in zip(one._fields, one, dp):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"sharded_ingest_step.{field} differs from fingerprint_batch")
    log(f"four cards: sharded_ingest_step == fingerprint_batch on device 0 "
        f"({sz.seq_songs} x {sz.track_s:.0f} s, every field "
        f"element-identical)")

    # 2. sequence-parallel fingerprint == single-card fingerprint
    from shazam_tpu.ops.fingerprint import (fingerprint_samples,
                                            fingerprints_to_pairs)

    song = jnp.asarray(songs[0])
    ref = jax.device_get(fingerprint_samples(
        jax.device_put(songs[0], jax.devices()[0]),
        jnp.int32(gen.n_samp), **kw))
    seq = jax.device_get(sequence_parallel_fingerprint(
        mesh, song, gen.n_samp, **kw))
    ref_set = set(zip(*(a.tolist() for a in fingerprints_to_pairs(ref))))
    seq_set = set(zip(*(a.tolist() for a in fingerprints_to_pairs(seq))))
    check(ref_set == seq_set,
          f"sequence-parallel hash set differs: {len(ref_set ^ seq_set)} "
          f"pairs")
    out["seq_collectives"] = _collectives(
        lambda x: sequence_parallel_fingerprint(mesh, x, gen.n_samp, **kw),
        song)
    log(f"four cards: sequence_parallel_fingerprint hash set == single "
        f"card ({len(ref_set)} pairs); collectives "
        f"{out['seq_collectives']}")

    # 3. both sharded regimes answer like the single card. Counts are
    # compared exact on both sides: with decision_escalation on, a
    # capacity-clamped answer whose top-1 margin is provably decided is
    # accepted with lower-bound counts (partial_counts), and the two
    # layouts clamp at different rows
    exact = dataclasses.replace(cfg, decision_escalation=False)
    cat.sia.config = exact
    solo = [cat.sia.recognize_clip(c) for c in cat.clips]
    cat.sia.config = cfg
    check(not any(r["partial_counts"] for r in solo),
          "single card: partial counts with decision_escalation off")
    solo = [_top(r) for r in solo]
    for regime, limit in (("key_range", 1 << 40), ("by_song", 0)):
        sc = ShardedCatalog(host_index, mesh=mesh, config=exact,
                            catalog=cat.sia.catalog, dense_limit_bytes=limit)
        check(sc.regime == regime, f"asked for {regime}, got {sc.regime}")
        for a in sc._shards:
            check(_spread_over(a, n_dev),
                  f"{regime}: an index shard array is not split over "
                  f"{n_dev} devices")
        rec = ShardedRecognizer(sc)
        for clip, name, s in zip(cat.clips, cat.clip_names, solo):
            res = rec.recognize_samples([clip])
            top = _top(res)
            check(top.get("song_name") == name == s.get("song_name"),
                  f"{regime}: clip of {name} matched {top.get('song_name')}"
                  f" (single card: {s.get('song_name')})")
            check(not res["partial_counts"], f"{regime}: partial counts")
            for key in ("offset", "hashes_matched_in_input"):
                check(top.get(key) == s.get(key),
                      f"{regime}: clip of {name} has {key} {top.get(key)},"
                      f" single card {s.get(key)}")
        query = ((jnp.zeros(1024, jnp.uint32),) * 4
                 + (jnp.ones(1024, bool),) * 2)
        coll = _collectives(_match_program(sc), sc._shards, sc._head,
                            *query)
        out[regime] = {"clips": len(cat.clips), "collectives": coll}
        log(f"four cards: {regime} regime, {len(cat.clips)} clips: top-1 "
            f"song, offset and matched count equal the single card's "
            f"(exact counts on both sides); collectives {coll}; index "
            f"shards split over {n_dev} devices")
        del rec, sc
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the four-card path and its "
                        "single-card comparison")
    p.add_argument("--tracks", type=int, default=BENCHMARK_TRACKS,
                   help="catalog size (default: the 2,714-track benchmark "
                        "catalog; 7986 is the production index)")
    args = p.parse_args(argv)

    dev, card = phase_device(args.chips)
    enable_compile_cache()
    import jax

    sz = Sizes(tracks=args.tracks)
    t0 = time.perf_counter()
    if args.chips == 4:
        run_four_cards(sz)
    else:
        run_one_card(sz, card)
    optional = [m for m in OPTIONAL_PACKAGES if m in sys.modules]
    check(not optional, f"the main path imported optional packages "
                        f"{optional}")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

"""End-to-end HTTP serving benchmark: QPS + latency through serve.py.

This drives the WHOLE production surface — HTTP listener,
WAV decode, micro-batching queue, recognize_batch dispatch, JSON
response — with concurrent closed-loop clients, the number a deployment
actually sees.  The reference's equivalent end-to-end figure is
0.34-1.4 s per query (BASELINE.md; one mic clip at a time over a DB
socket).

Env knobs:
  SERVE_SONGS   catalog size to synthesize (default 32)
  SERVE_DUR     seconds per catalog song (default 30)
  SERVE_CLIP    query clip seconds (default 5)
  SERVE_CLIENTS concurrent closed-loop clients (default 16)
  SERVE_REQS    requests per client (default 8)
  SERVE_MAX_BATCH / SERVE_WAIT_MS   batcher knobs (default 16 / 10)
  SERVE_ACC_MIN accuracy floor (default 1.0 — every clip must top-1
                its song; lower it ONLY for corpora with verified
                5 s near-collisions, e.g. the 95.3M tone build's two
                deterministic colliding clips)

Latency here is the client's: HTTP, decode, batching, device and JSON.
Accuracy is asserted (every clip must top-1 its song).
"""

import http.client
import io
import json
import os
import sys
import threading
import time
import wave

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

SONGS = int(os.environ.get("SERVE_SONGS", 32))
DUR = float(os.environ.get("SERVE_DUR", 30.0))
CLIP = float(os.environ.get("SERVE_CLIP", 5.0))
CLIENTS = int(os.environ.get("SERVE_CLIENTS", 16))
REQS = int(os.environ.get("SERVE_REQS", 8))
MAX_BATCH = int(os.environ.get("SERVE_MAX_BATCH", 16))
WAIT_MS = float(os.environ.get("SERVE_WAIT_MS", 10.0))
FS = 44100


def _wav_bytes(samples):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(FS)
        wf.writeframes(np.asarray(samples).astype(np.int16).tobytes())
    return buf.getvalue()


def _load_prebuilt(prefix):
    """SERVE_DB mode: serve a catalog_full.py CATALOG_SAVE build (e.g.
    the 95.3M-hash production-scale index) instead of synthesizing one.

    Query clips come from catalog_full's device-side generator — set the
    same CATALOG_SONGS/CATALOG_DURATION the build used. Returns
    (sia, clips_by_key, n_songs)."""
    import jax
    import jax.numpy as jnp

    from shazam_tpu import SIA

    import catalog_full as cf

    # host-backed like the production CLI default (cli.py): the API then
    # serves through the unique-key search view (api._ensure_uview)
    sia = SIA(catalog_path=prefix + ".sqlite")
    t0 = time.time()
    sia.load_index(prefix + ".idx.npz")
    print(f"loaded {sia._live_n_hashes()}-hash index in "
          f"{time.time()-t0:.0f}s", flush=True)

    from jax import lax

    gen = cf._make_gen()

    # slice each clip ON DEVICE and download 430 KB, not the whole
    # 300 MB song batch per base
    @jax.jit
    def clip_of(sids_d, row, start):
        songs = gen(sids_d)
        c = lax.dynamic_slice(songs, (row, start), (1, int(CLIP * FS)))
        return c[0].astype(jnp.int16)

    rng = np.random.default_rng(5)
    clips, want = [], []
    need = CLIENTS * REQS
    sids = rng.integers(0, cf.N_SONGS, need)
    starts = rng.integers(0, cf.N_SAMP - int(CLIP * FS), need)
    for k in range(need):
        sid = int(sids[k])
        base = sid // cf.BATCH * cf.BATCH
        ids = jnp.asarray(np.arange(
            base, min(base + cf.BATCH, cf.N_SONGS), dtype=np.int32))
        clips.append(np.asarray(clip_of(ids, jnp.int32(sid - base),
                                        jnp.int32(int(starts[k])))))
        want.append(f"track{sid:06d}")
    return sia, clips, want


def main():
    from shazam_tpu import SIA
    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.serve import RecognitionServer, warmup

    prebuilt = os.environ.get("SERVE_DB")
    if prebuilt:
        sia, clips, want = _load_prebuilt(prebuilt)
    else:
        print(f"ingesting {SONGS} x {DUR:.0f}s ...", flush=True)
        sia = SIA()
        sia.ingest_arrays(
            [(f"track{i:06d}", synth_song(i, duration_s=DUR, seed=77))
             for i in range(SONGS)])

    tiers_to_warm = ()
    pin = os.environ.get("SERVE_PIN", "decide" if prebuilt else "")
    pin_cap = None
    if prebuilt:
        # probe REAL clips for the capacity tiers this corpus actually
        # dispatches at, so no live request pays a compile. SERVE_PIN
        # modes:
        #   decide (default) — pin the DECIDE tier: clamped clips are
        #     margin-certified, so batches stay on the cheap program and
        #     only genuinely undecided clips retry solo. Pinning the MAX
        #     fitting tier instead (SERVE_PIN=auto) multiplies every
        #     batch's device work when most 5 s clips fit a tier below
        #     the max.
        #   auto — pin the max fitting tier across 16 probes.
        #   <int> — pin that capacity.
        ladder = sia._match_tiers()
        fits = []
        for c in clips[:16]:
            t = sia.recognize_samples([c]).get("total_matches", 0)
            fits.append(next((x for x in ladder if x >= t), ladder[-1]))
        tiers_to_warm = tuple(sorted(set(fits)))
        print(f"fitting tiers from real clips: {tiers_to_warm}", flush=True)
    if pin == "decide" and prebuilt:
        # the MEDIAN fitting tier (never below the decide tier): about
        # half the clips fit outright, the rest clamp and are margin-
        # certified or retried. Pinning the bare decide tier on a
        # skewed corpus (music 5 s, totals mostly past 65536 with weak
        # 5 s margins) drowns in solo retries.
        med = sorted(fits)[len(fits) // 2]
        pin_cap = max(sia._decide_cap(sia._match_tiers()), med)
    elif pin == "auto" and tiers_to_warm:
        pin_cap = tiers_to_warm[-1]
    elif pin and pin not in ("auto", "decide"):
        pin_cap = int(pin)
    print(f"warming serving programs (pin_capacity={pin_cap}) ...",
          flush=True)
    warmup(sia, seconds=CLIP, max_batch=MAX_BATCH,
           capacity_tiers=tiers_to_warm if pin_cap is None else (),
           pin_capacity=pin_cap)

    srv = RecognitionServer(sia, port=0, max_batch=MAX_BATCH,
                            max_wait_ms=WAIT_MS, request_timeout_s=600.0,
                            pin_capacity=pin_cap)
    srv.start_background()

    if prebuilt:
        bodies = [_wav_bytes(c) for c in clips]
    else:
        rng = np.random.default_rng(5)
        bodies, want = [], []
        for i in range(CLIENTS * REQS):
            sid = int(rng.integers(0, SONGS))
            start = int(rng.integers(0, int((DUR - CLIP) * FS)))
            song = synth_song(sid, duration_s=DUR, seed=77)
            bodies.append(_wav_bytes(song[start: start + int(CLIP * FS)]))
            want.append(f"track{sid:06d}")

    # SERVE_SWEEP="4,16,64": concurrency sweep against the SAME warmed
    # server process (one load + warmup amortized over every point).
    sweep = [int(c) for c in
             os.environ.get("SERVE_SWEEP", str(CLIENTS)).split(",")]
    all_wrong = []
    worst_acc = 1.0
    for n_clients in sweep:
        lat, wrong = [], []
        lock = threading.Lock()
        n_total = len(bodies)

        errors = []

        def client(cid, n_clients=n_clients):
            # ONE persistent HTTP/1.1 keep-alive connection per client,
            # like a real SDK (client.py does the same): urllib's
            # one-connection-per-request churned a fresh handler THREAD
            # per request through ThreadingHTTPServer — measurable host
            # overhead at high concurrency on small machines
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=600)
            for k in range(cid, n_total, n_clients):
                t0 = time.time()
                try:
                    conn.request("POST", "/recognize?topn=1",
                                 body=bodies[k])
                    resp = conn.getresponse()
                    body = resp.read()   # drain even on error statuses
                    if resp.status != 200:
                        # http.client does not raise on non-2xx (urllib
                        # did) — count it instead of crashing the client
                        # thread on the missing "results" key, which
                        # would silently skip its remaining requests
                        raise RuntimeError(
                            f"HTTP {resp.status}: {body[:200]!r}")
                    out = json.loads(body)
                except Exception as e:  # noqa: BLE001 — count, keep going
                    with lock:
                        errors.append((k, repr(e)))
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", srv.port, timeout=600)
                    continue
                dt = time.time() - t0
                top = (out["results"][0]["song_name"]
                       if out["results"] else None)
                with lock:
                    lat.append(dt)
                    if top != want[k]:
                        wrong.append((k, want[k], top))
            conn.close()

        b0 = dict(srv.batcher.stats)
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0

        lat = np.array(sorted(lat))
        n = len(lat)
        if n == 0:
            print(json.dumps({"clients": n_clients, "requests": 0,
                              "errors": len(errors)}), flush=True)
            print("ERRORS:", errors[:5], flush=True)
            all_wrong.append(("all-errors", n_clients))
            worst_acc = 0.0
            continue
        stats = srv.batcher.stats
        batches = stats["batches"] - b0.get("batches", 0)
        breqs = stats["batched_requests"] - b0.get("batched_requests", 0)
        mean_batch = breqs / batches if batches else 1.0
        print(json.dumps({
            "requests": n,
            "wrong": len(wrong),
            "qps": round(n / wall, 1),
            "latency_p50_ms": round(float(lat[n // 2]) * 1e3, 1),
            "latency_p95_ms": round(float(lat[int(n * 0.95)]) * 1e3, 1),
            "latency_p99_ms": round(float(lat[min(int(n * 0.99), n - 1)])
                                    * 1e3, 1),
            "mean_batch": round(mean_batch, 2),
            "batches": batches,
            "clients": n_clients,
            "max_batch": MAX_BATCH,
            "pin": pin_cap,
            "wait_ms": WAIT_MS,
            "errors": len(errors),
            # batcher stage seconds over this sweep: device dispatch +
            # RTT (match_s) and stage-1 fingerprint/prep (prepare_s) —
            # wall far above match_s+prepare_s means the listener is
            # HOST-bound (decode/JSON/GIL), not device-bound
            "match_s": round(stats.get("match_s", 0.0)
                             - b0.get("match_s", 0.0), 2),
            "prepare_s": round(stats.get("prepare_s", 0.0)
                               - b0.get("prepare_s", 0.0), 2),
            "wall_s": round(wall, 2),
        }), flush=True)
        if errors:
            print("ERRORS:", errors[:5], flush=True)
        all_wrong.extend(wrong)
        worst_acc = min(worst_acc, 1.0 - len(wrong) / n)
    srv.close()
    if all_wrong:
        print("WRONG:", all_wrong[:10])
    acc_min = float(os.environ.get("SERVE_ACC_MIN", 1.0))
    print(f"worst sweep accuracy {worst_acc:.4f} (floor {acc_min})",
          flush=True)
    if worst_acc < acc_min:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

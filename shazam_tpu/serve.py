"""HTTP serving daemon: micro-batched recognition, one device dispatch.

The reference's serving story is interactive scripts — a mic capture
loop (``recognizer.py:355-398``) and per-query DB round trips. A
production accelerator deployment wants the opposite shape: concurrent
requests gathered into ONE vmapped device program (``match/batched.py``),
so the device sees a ``(B, Q)`` batch instead of B serial dispatches.

This daemon is that shape over plain HTTP (stdlib only, no deps):

- ``POST /recognize`` — body is a WAV file; replies with the same JSON
  ``SIA.recognize_samples`` returns.  Mono requests park in a
  micro-batching queue (``max_batch`` / ``max_wait_ms``) and whole
  batches are answered from one ``recognize_batch`` call; multi-channel
  requests run channel-unioned via ``recognize_samples``.
- ``POST /ingest?name=<song>`` — body is a WAV file; fingerprints it
  and grows the live index (the reference ingested into the shared DB
  while recognizers queried it).  Runs on the batcher thread between
  recognition batches; see ``SIA.ingest_channels`` for the
  program-shape caveat (use a device-resident index with reserved
  capacity so online growth doesn't recompile the match program).
- ``POST /delete?songs=<ids-or-names>`` — remove songs from the live
  catalog and index (the reference's DELETE_SONGS admin queries,
  ``fingerprints_queries.sql``).
- ``GET /stats`` — catalog counts + serving counters (requests,
  batches, largest batch, ingests) and rolling queue->response
  latency quantiles for observability.
- ``GET /metrics`` — the same counters in Prometheus text exposition
  format for scrape-based monitoring.
- ``POST /save`` — snapshot the live index/catalog to disk on demand
  (the per-mutation ``--persist`` flag's explicit sibling; runs on the
  batcher thread so it never interleaves with a device program).
- ``POST /stream/open|feed|recognize|close`` — continuous-listening
  sessions over HTTP: raw int16 PCM chunks feed an incremental
  ``StreamRecognizer`` (device work proportional to NEW audio — the
  reference's capture loop refingerprints the whole window,
  ``recognizer.py:355-382``), so a client can stream a mic and poll
  matches mid-stream. Sessions are capped and idle-evicted.
- ``GET /healthz`` — liveness.

Catalog mutations can be gated behind a bearer token
(``RecognitionServer(auth_token=...)`` / ``serve --auth-token`` /
``SHAZAM_SERVE_TOKEN``): recognition stays open, but /ingest, /delete
and /save then require ``Authorization: Bearer <token>``.

Threading model: HTTP handler threads only decode audio and wait on an
event. The batcher thread owns every engine MUTATION (ingest/delete/
save/streams) and stage 1 of recognition (fingerprint + query prep);
a second match thread runs stage 2 (match dispatch + align) on a
depth-1 pipeline, so batch k+1 fingerprints while batch k's match
round-trips the device (``pipeline=False`` restores the single-thread
round-robin). Mutations quiesce the pipeline first, so the engine
still never sees concurrent mutation.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


class _Pending:
    """One parked request: decoded channels + a completion event.

    ``kind`` is "recognize" or "ingest" (``name`` set for the latter);
    ``t0`` stamps post-decode submit time for the /stats latency track.
    """

    __slots__ = ("channels", "topn", "event", "result", "error", "kind",
                 "name", "extra", "t0")

    def __init__(self, channels: List[np.ndarray], topn: Optional[int],
                 kind: str = "recognize", name: Optional[str] = None,
                 extra: Optional[Dict] = None):
        self.channels = channels
        self.topn = topn
        self.kind = kind
        self.name = name
        self.extra = extra
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.t0 = time.monotonic()


class MicroBatcher:
    """Gather concurrent requests into one ``recognize_batch`` dispatch.

    Wakes on the first queued request, then waits up to ``max_wait_ms``
    (or until ``max_batch``) for companions — the classic serving
    latency/throughput knob.  Mono clips with one ``topn`` share a
    batch; anything else (multi-channel, mixed topn) is answered
    individually on the same thread, so the engine is single-threaded
    by construction.
    """

    def __init__(self, sia, max_batch: int = 16, max_wait_ms: float = 10.0,
                 persist_path: Optional[str] = None, max_streams: int = 8,
                 stream_ttl_s: float = 300.0, pipeline: bool = True,
                 pin_capacity: Optional[int] = None):
        self.sia = sia
        self.persist_path = persist_path
        # pin_capacity: dispatch EVERY micro-batch at this match-capacity
        # tier (the bounds probe still runs and its bounds are reused, so
        # warmup's pinned-tier programs ARE the live programs). Without a
        # pin, bounds-first picks the per-batch fitting tier — each tier a
        # batch hits is a separate compile, which lands inside a live
        # request when that tier was not warmed. Pin the
        # max tier your corpus' clips fit (serve_qps SERVE_PIN=auto
        # probes it) and warm exactly that.
        self.pin_capacity = int(pin_capacity) if pin_capacity else None
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.max_streams = int(max_streams)
        self.stream_ttl = float(stream_ttl_s)
        # session id -> [StreamRecognizer, last-touch monotonic]; only
        # the batcher thread reads or writes it
        self._streams: Dict[str, list] = {}
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "max_batch": 0, "errors": 0, "ingests": 0}
        # rolling queue->response latencies (seconds); /stats summarizes
        self._lat: deque = deque(maxlen=4096)
        self._slock = threading.Lock()  # stats/_lat cross two threads now
        self._stop = threading.Event()
        # two-stage pipeline: the batcher thread decodes + fingerprints
        # (SIA.prepare_batch) and hands prepared batches to the match
        # thread (SIA.match_prepared_batch), so batch k+1's fingerprint
        # dispatch overlaps batch k's match round trip, so the host
        # round trip per dispatch no longer serializes the whole daemon.
        # maxsize=1 = exactly one batch in flight behind the matcher.
        self.pipeline = bool(pipeline) and hasattr(sia, "prepare_batch")
        self._pipe: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sia-batcher")
        self._thread.start()
        self._mthread = None
        if self.pipeline:
            self._mthread = threading.Thread(target=self._match_loop,
                                             daemon=True, name="sia-matcher")
            self._mthread.start()

    def submit(self, p: _Pending) -> None:
        self.q.put(p)

    def close(self) -> None:
        self._stop.set()
        self.q.put(None)  # wake the loop
        self._thread.join(timeout=5)
        if self._mthread is not None:
            self._mthread.join(timeout=5)

    # ---- batcher thread -------------------------------------------------
    def _collect(self, first: _Pending) -> List[_Pending]:
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                p = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if p is None:
                break
            batch.append(p)
        return batch

    def _finish(self, p: _Pending) -> None:
        """Attach metadata and release the waiter — called per request
        the moment its result exists, so batched answers never wait on
        slower requests from the same collection round. Called from the
        batcher AND the match thread (pipeline), hence the lock."""
        if p.result is not None and p.result.get("results"):
            p.result["metadata"] = self._metadata_for(
                p.result["results"][0]["song_name"])
        with self._slock:
            self.stats["requests"] += 1
            self._lat.append(time.monotonic() - p.t0)
        p.event.set()

    def _batch_stats(self, n: int) -> None:
        with self._slock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += n
            self.stats["max_batch"] = max(self.stats["max_batch"], n)

    def _flush(self) -> None:
        """Quiesce the pipeline: wait until the match thread has drained
        every handed-off batch (no-op when the pipeline is off/empty)."""
        self._pipe.join()

    def _match_loop(self) -> None:
        """Stage-2 thread: match dispatch + escalation + align for
        prepared batches. Device dispatch from two threads is safe (JAX
        serializes programs); engine MUTATIONS stay on the batcher
        thread, which flushes this pipe first."""
        while True:
            try:
                item = self._pipe.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                pb, mono = item
                try:
                    t_m = time.monotonic()
                    outs = self.sia.match_prepared_batch(pb)
                    with self._slock:
                        # device match dispatch + host round trip, summed —
                        # serve_qps reports it next to wall time so a
                        # listener-vs-device throughput gap is
                        # attributable (host-bound vs device-bound)
                        self.stats["match_s"] = (
                            self.stats.get("match_s", 0.0)
                            + (time.monotonic() - t_m))
                    for p, out in zip(mono, outs):
                        p.result = out
                except Exception as e:  # noqa: BLE001 — per request
                    with self._slock:
                        self.stats["errors"] += len(mono)
                    for p in mono:
                        p.error = f"{type(e).__name__}: {e}"
                self._batch_stats(len(mono))
                for p in mono:
                    self._finish(p)
            except Exception:  # noqa: BLE001 — the matcher must survive
                pass
            finally:
                self._pipe.task_done()

    def latency_summary(self) -> Dict:
        """count/mean/p50/p99 of recent queue->response latencies (ms)."""
        with self._slock:
            lats = sorted(self._lat)
        if not lats:
            return {"count": 0}
        n = len(lats)
        return {
            "count": n,
            "mean_ms": round(1000 * sum(lats) / n, 2),
            "p50_ms": round(1000 * lats[n // 2], 2),
            "p99_ms": round(1000 * lats[min(n - 1, (99 * n) // 100)], 2),
        }

    def _answer(self, batch: List[_Pending]) -> None:
        # catalog mutations (ingest/delete) run individually on this
        # same thread; with the pipeline on, the engine is quiesced
        # first (the match thread reads index state mid-batch — a
        # concurrent mutation could hand it inconsistent device arrays)
        admin = [p for p in batch if p.kind != "recognize"]
        batch = [p for p in batch if p.kind == "recognize"]
        if any(p.kind in ("ingest", "delete") for p in admin):
            self._flush()
        for p in admin:
            try:
                if p.kind == "save":
                    path = p.name or self.persist_path
                    if not path:
                        raise ValueError(
                            "no save path: pass ?path= or start with --persist")
                    self.sia.save_index(path)
                    p.result = {"saved": path}
                    self.stats["saves"] = self.stats.get("saves", 0) + 1
                    self._finish(p)
                    continue
                if p.kind.startswith("stream_"):
                    p.result = self._stream_op(p)
                    self._finish(p)
                    continue
                if not hasattr(self.sia, "ingest_channels"):
                    raise RuntimeError(
                        "this engine does not support online catalog "
                        "mutation (e.g. a sharded recognizer facade)")
                if p.kind == "ingest":
                    p.result = self.sia.ingest_channels(p.name, p.channels)
                    self.stats["ingests"] += 1
                    changed = bool(p.result.get("ingested"))
                else:
                    ids = self._resolve_song_ids(p.name)
                    removed = self.sia.delete_songs(ids)
                    p.result = {"deleted_songs": len(ids),
                                "removed_rows": removed}
                    self.stats["deletes"] = self.stats.get("deletes", 0) + 1
                    changed = bool(ids)
                if self.persist_path and changed:
                    # durability: without this, a daemon crash leaves the
                    # song's fingerprinted flag in sqlite but its rows
                    # nowhere (load_index reconciles by purging, so the
                    # song would need re-ingesting). Full index rewrite
                    # per mutation — size the flag to your catalog.
                    self.sia.save_index(self.persist_path)
            except Exception as e:  # noqa: BLE001 — reported per request
                with self._slock:
                    self.stats["errors"] += 1
                p.error = f"{type(e).__name__}: {e}"
            self._finish(p)
        if not batch:
            return
        # batchable: mono, all the same topn. Size-1 "batches" go
        # through recognize_batch too: it is the path the warmup (incl.
        # capacity_tiers) precompiles — recognize_samples' escalated-
        # tier single-query programs would compile inside the first
        # low-concurrency request that clamps.
        mono = [p for p in batch if len(p.channels) == 1]
        topns = {p.topn for p in mono}
        if mono and len(topns) == 1:
            if self.pipeline:
                # stage 1 here (fingerprint dispatch + host query prep),
                # stage 2 on the match thread: while batch k round-trips
                # its match dispatch, this thread is already collecting
                # and fingerprinting batch k+1
                try:
                    t_p = time.monotonic()
                    pin_kw = ({"match_capacity": self.pin_capacity}
                              if self.pin_capacity else {})
                    pb = self.sia.prepare_batch(
                        [p.channels[0] for p in mono], topn=mono[0].topn,
                        pad_to_pow2=True, **pin_kw)
                    with self._slock:
                        # stage-1 host+fingerprint-dispatch time (see
                        # match_s above for the stage-2 counterpart)
                        self.stats["prepare_s"] = (
                            self.stats.get("prepare_s", 0.0)
                            + (time.monotonic() - t_p))
                    self._pipe.put((pb, mono))  # blocks at depth 1
                except Exception as e:  # noqa: BLE001 — per request
                    with self._slock:
                        self.stats["errors"] += len(mono)
                    for p in mono:
                        p.error = f"{type(e).__name__}: {e}"
                        self._finish(p)
            else:
                try:
                    # pad_to_pow2: varying micro-batch sizes must not
                    # each compile a fresh device program —
                    # O(log max_batch) shapes.
                    # pin_capacity only when set: facade engines without
                    # the kwarg (e.g. ShardedRecognizer) stay servable
                    pin_kw = ({"match_capacity": self.pin_capacity}
                              if self.pin_capacity else {})
                    outs = self.sia.recognize_batch(
                        [p.channels[0] for p in mono], topn=mono[0].topn,
                        pad_to_pow2=True, **pin_kw)
                    for p, out in zip(mono, outs):
                        p.result = out
                except Exception as e:  # noqa: BLE001 — per request
                    with self._slock:
                        self.stats["errors"] += len(mono)
                    for p in mono:
                        p.error = f"{type(e).__name__}: {e}"
                self._batch_stats(len(mono))
                for p in mono:
                    self._finish(p)
            rest = [p for p in batch if len(p.channels) != 1]
        else:
            rest = batch
        for p in rest:
            try:
                p.result = self.sia.recognize_samples(p.channels, topn=p.topn)
            except Exception as e:  # noqa: BLE001
                with self._slock:
                    self.stats["errors"] += 1
                p.error = f"{type(e).__name__}: {e}"
            self._finish(p)

    def _resolve_song_ids(self, spec: str) -> List[int]:
        """Delete spec -> song ids: comma-separated ids and/or names."""
        ids = []
        by_name = None
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.isdigit():
                ids.append(int(tok))
                continue
            if by_name is None:
                by_name = {d["song_name"]: d["song_id"]
                           for d in self.sia.catalog.get_songs()}
            if tok not in by_name:
                raise ValueError(f"unknown song name {tok!r}")
            ids.append(by_name[tok])
        return ids

    def _stream_op(self, p: _Pending) -> Dict:
        """Streaming-session ops — batcher-thread only, so sessions need
        no locking and their device programs never interleave with a
        recognition batch."""
        now = time.monotonic()
        for sid in [s for s, (_, last) in self._streams.items()
                    if now - last > self.stream_ttl]:
            del self._streams[sid]  # idle eviction
        if p.kind == "stream_open":
            if len(self._streams) >= self.max_streams:
                raise RuntimeError(
                    f"too many open streams (max {self.max_streams}); "
                    "close one or raise --max-streams")
            from .stream import StreamRecognizer

            opts = p.extra or {}
            sr = StreamRecognizer(
                self.sia, channels=int(opts.get("channels", 1)),
                window_seconds=float(opts.get("window", 15.0)),
                engine=opts.get("engine", "host"))
            sid = os.urandom(8).hex()
            self._streams[sid] = [sr, now]
            self.stats["streams"] = self.stats.get("streams", 0) + 1
            return {"session": sid, "channels": sr.channels,
                    "window_seconds": sr.window_seconds}
        entry = self._streams.get(p.name)
        if entry is None:
            raise ValueError(f"unknown or expired stream session {p.name!r}")
        entry[1] = now
        sr = entry[0]
        if p.kind == "stream_close":
            del self._streams[p.name]
            return {"closed": True}
        if p.kind == "stream_feed":
            chunk = p.channels[0]
            if len(chunk) % sr.channels:
                raise ValueError(
                    f"chunk length {len(chunk)} is not a multiple of the "
                    f"session's {sr.channels} interleaved channels")
            sr.feed(chunk)
            out = {"buffered_seconds": round(sr.buffered_seconds, 3)}
            if (p.extra or {}).get("recognize"):
                out.update(sr.recognize(topn=p.topn))
            return out
        return sr.recognize(topn=p.topn)  # stream_recognize

    def _metadata_for(self, song_name):
        """Top-match metadata, the reference one-shot flow's last step
        (``recognizer.py:397``); None when the catalog has none or the
        lookup fails (a transient sqlite error must not kill the
        batcher or withhold an already-computed match)."""
        try:
            return self.sia.get_metadata(int(song_name))
        except Exception:  # noqa: BLE001 — metadata is best-effort
            return None

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            batch = self._collect(first)
            try:
                self._answer(batch)
            except Exception as e:  # noqa: BLE001 — the batcher thread
                # must survive anything: a dead consumer turns every
                # future request into a silent timeout
                for p in batch:
                    if not p.event.is_set():
                        with self._slock:
                            self.stats["errors"] += 1
                            self.stats["requests"] += 1
                        p.error = f"{type(e).__name__}: {e}"
                        p.event.set()


def _make_handler(batcher: MicroBatcher, sia, timeout_s: float,
                  max_clip_seconds: float = 60.0,
                  max_ingest_seconds: float = 600.0,
                  auth_token: Optional[str] = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # an undrained body means the socket can't carry another
                # request — tell the client instead of a later broken pipe
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _discard_body(self, drain_cap: int = 64 << 20) -> None:
            """Read and discard the declared request body so a keep-alive
            connection stays usable for the error reply; a body beyond
            ``drain_cap`` isn't worth reading — mark the connection for
            close (``_json`` advertises it) and skip the read."""
            if self.headers.get("Transfer-Encoding"):
                # chunked bodies have no Content-Length to drain by —
                # the unread chunks would poison the next request on
                # this connection, so close it instead
                self.close_connection = True
                return
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length <= 0:
                return
            if length > drain_cap:
                self.close_connection = True
                return
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                length -= len(chunk)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"ok": True})
            elif path == "/stats":
                catalog = getattr(sia, "catalog", None)
                counts = catalog.counts() if catalog is not None else {}
                extra = {}
                if getattr(sia, "_decide_boost", 0):
                    # the self-tuning decide tier raised itself (see
                    # config.decide_adapt_window) — surface it so an
                    # operator can pin it across restarts
                    extra["decide_boost"] = sia._decide_boost
                    try:
                        extra["decide_tier"] = sia._decide_cap(
                            sia._match_tiers())
                    except Exception:  # noqa: BLE001 — observability only
                        pass
                self._json(200, {**counts, **batcher.stats, **extra,
                                 "latency": batcher.latency_summary(),
                                 "index_hashes": sia._live_n_hashes()})
            elif path == "/metrics":
                body = _prometheus_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {path}"})

        def _authorized(self) -> bool:
            """Catalog mutations (/ingest, /delete, /save) require
            ``Authorization: Bearer <token>`` when the daemon was started
            with one; recognition and streaming stay open. Constant-time
            compare so the token can't be probed byte by byte."""
            if auth_token is None:
                return True
            import hmac

            got = self.headers.get("Authorization", "")
            # compare as bytes: compare_digest raises TypeError on
            # non-ASCII str (http.server decodes headers as latin-1,
            # so a stray header would crash the handler instead of 401)
            return hmac.compare_digest(
                got.encode("latin-1", errors="replace"),
                f"Bearer {auth_token}".encode("latin-1", errors="replace"))

        def _deny(self) -> None:
            self._discard_body()
            body = json.dumps(
                {"error": "authorization required for catalog mutation"}
            ).encode()
            self.send_response(401)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("WWW-Authenticate", "Bearer")
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            parsed = urlparse(self.path)
            if parsed.path in ("/delete", "/save", "/ingest") \
                    and not self._authorized():
                self._deny()
                return
            if parsed.path == "/delete":
                self._do_delete(parsed)
                return
            if parsed.path == "/save":
                qs = parse_qs(parsed.query)
                self._discard_body()  # drain for keep-alive
                self._await(_Pending([], None, kind="save",
                                     name=qs.get("path", [None])[0]))
                return
            if parsed.path.startswith("/stream/"):
                self._do_stream(parsed)
                return
            if parsed.path not in ("/recognize", "/ingest"):
                self._json(404, {"error": f"no route {parsed.path}"})
                return
            ingest = parsed.path == "/ingest"
            try:
                qs = parse_qs(parsed.query)
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 256 << 20:
                    self._discard_body()
                    self._json(400, {"error": "missing or oversized body"})
                    return
                # drain the body BEFORE any validation reply: responding
                # with unread bytes on the socket breaks keep-alive (the
                # client sees a broken pipe instead of the 400)
                raw = self.rfile.read(length)
                name = None
                if ingest:
                    if "name" not in qs or not qs["name"][0]:
                        self._json(400, {"error": "ingest requires ?name="})
                        return
                    name = qs["name"][0]
                topn = int(qs["topn"][0]) if "topn" in qs else None
                channels = _decode_wav_bytes(
                    raw,
                    max_s=max_ingest_seconds if ingest else max_clip_seconds,
                )
            except Exception as e:  # noqa: BLE001 — client error report
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            p = _Pending(channels, topn,
                         kind="ingest" if ingest else "recognize", name=name)
            self._await(p)

        def _do_stream(self, parsed) -> None:
            """POST /stream/<open|feed|recognize|close> — continuous
            listening over HTTP.  ``feed`` bodies are raw interleaved
            little-endian int16 PCM (no per-chunk WAV headers;
            ``?recognize=1`` also matches the updated window in the
            same round trip); the other ops take no body."""
            op = parsed.path[len("/stream/"):]
            qs = parse_qs(parsed.query)
            if self.headers.get("Transfer-Encoding"):
                self._discard_body()  # chunked: mark connection for close
                self._json(400, {"error": "chunked bodies are not "
                                 "supported; send Content-Length"})
                return
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = b""
            if length > 0:
                if length > 64 << 20:
                    self._discard_body()
                    self._json(400, {"error": "oversized stream chunk"})
                    return
                raw = self.rfile.read(length)
            if op == "open":
                try:
                    extra = {
                        "channels": int(qs.get("channels", ["1"])[0]),
                        "window": float(qs.get("window", ["15"])[0]),
                        "engine": qs.get("engine", ["host"])[0],
                    }
                except ValueError as e:
                    self._json(400, {"error": f"bad stream params: {e}"})
                    return
                self._await(_Pending([], None, kind="stream_open",
                                     extra=extra))
                return
            if op not in ("feed", "recognize", "close"):
                self._json(404, {"error": f"no stream op {op!r}"})
                return
            if "session" not in qs or not qs["session"][0]:
                self._json(400, {"error": f"stream {op} requires ?session="})
                return
            topn = int(qs["topn"][0]) if "topn" in qs else None
            if op == "feed":
                if not raw or len(raw) % 2:
                    self._json(400, {"error": "feed body must be raw "
                                     "interleaved int16 PCM"})
                    return
                chunk = np.frombuffer(raw, dtype="<i2")
                rec = qs.get("recognize", ["0"])[0] not in ("0", "false", "")
                p = _Pending([chunk], topn, kind="stream_feed",
                             name=qs["session"][0],
                             extra={"recognize": rec})
            else:
                p = _Pending([], topn, kind=f"stream_{op}",
                             name=qs["session"][0])
            self._await(p)

        def _do_delete(self, parsed) -> None:
            """POST /delete?songs=<id-or-name>,... — the reference's
            DELETE_SONGS admin workflow (``mysql_database.py:136-138``,
            ``fingerprints_queries.sql``) against the live catalog."""
            qs = parse_qs(parsed.query)
            # drain any body so keep-alive connections stay usable
            self._discard_body()
            if "songs" not in qs or not qs["songs"][0]:
                self._json(400, {"error": "delete requires ?songs=ids,names"})
                return
            p = _Pending([], None, kind="delete", name=qs["songs"][0])
            self._await(p)

        def _await(self, p: _Pending) -> None:
            batcher.submit(p)
            if not p.event.wait(timeout=timeout_s):
                self._json(504, {"error": "request timed out"})
                return
            if p.error is not None:
                self._json(500, {"error": p.error})
            else:
                self._json(200, p.result)

    def _decode_wav_bytes(raw: bytes,
                          max_s: float = max_clip_seconds) -> List[np.ndarray]:
        """Decode the request body in memory (WAV: the same parser
        ingest uses, no disk spool, no discarded file SHA-1 — two full
        passes saved per request); non-RIFF payloads spool to a temp
        file for the ffmpeg path."""
        from .audio.io import read, read_wav_bytes

        if raw[:4] == b"RIFF" and raw[8:12] == b"WAVE":
            channels, fs = read_wav_bytes(raw)
        else:
            # non-WAVE RIFF containers (e.g. AVI) belong to ffmpeg too
            fd, tmp = tempfile.mkstemp(suffix=".bin")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(raw)
                channels, fs, _sha = read(tmp)
            finally:
                os.unlink(tmp)
        if fs != sia.config.sample_rate:
            if not getattr(sia, "resample", False):
                raise ValueError(
                    f"sample rate {fs} != config {sia.config.sample_rate}")
            from .audio.resample import resample_channels

            channels = resample_channels(channels, fs,
                                         sia.config.sample_rate)
            fs = sia.config.sample_rate
        if len(channels[0]) > max_s * fs:
            # every new length bucket compiles a fresh device program
            # — cap what one request can
            # force, and warm the durations you actually accept
            # (warmup(clip_lengths=...)); set the cap to your clip
            # policy so a stray upload can't stall the batcher
            raise ValueError(f"audio exceeds the {max_s:g} s request cap")
        return channels

    def _prometheus_metrics() -> str:
        """Serving counters in Prometheus text exposition format (the
        scrape-based twin of /stats; stdlib-only like the rest of the
        daemon)."""
        counters = {
            "requests": "recognition/admin requests answered",
            "batched_requests": "requests answered from a shared batch",
            "batches": "micro-batched device dispatches",
            "errors": "requests answered with an error",
            "ingests": "online ingests applied",
            "deletes": "online deletions applied",
            "saves": "on-demand index snapshots",
            "streams": "streaming sessions opened",
        }
        lines = []
        for key, help_text in counters.items():
            lines.append(f"# HELP sia_{key}_total {help_text}")
            lines.append(f"# TYPE sia_{key}_total counter")
            lines.append(f"sia_{key}_total {batcher.stats.get(key, 0)}")
        lines.append("# HELP sia_max_batch largest micro-batch so far")
        lines.append("# TYPE sia_max_batch gauge")
        lines.append(f"sia_max_batch {batcher.stats.get('max_batch', 0)}")
        catalog = getattr(sia, "catalog", None)
        if catalog is not None:
            for k, v in catalog.counts().items():
                lines.append(f"# TYPE sia_catalog_{k} gauge")
                lines.append(f"sia_catalog_{k} {v}")
        lines.append("# TYPE sia_index_hashes gauge")
        lines.append(f"sia_index_hashes {sia._live_n_hashes()}")
        lat = batcher.latency_summary()
        lines.append("# HELP sia_request_latency_milliseconds "
                     "queue->response latency over the rolling window")
        lines.append("# TYPE sia_request_latency_milliseconds summary")
        for q in ("p50", "p99"):
            if f"{q}_ms" in lat:
                lines.append(
                    "sia_request_latency_milliseconds"
                    f'{{quantile="0.{q[1:]}"}} {lat[f"{q}_ms"]}')
        lines.append("sia_request_latency_milliseconds_count "
                     f"{lat.get('count', 0)}")
        return "\n".join(lines) + "\n"

    return Handler


class RecognitionServer:
    """Own the HTTP listener + micro-batcher around one SIA engine."""

    def __init__(self, sia, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 16, max_wait_ms: float = 10.0,
                 request_timeout_s: float = 120.0,
                 max_clip_seconds: float = 60.0,
                 max_ingest_seconds: float = 600.0,
                 persist_path: Optional[str] = None,
                 max_streams: int = 8, stream_ttl_s: float = 300.0,
                 auth_token: Optional[str] = None, pipeline: bool = True,
                 pin_capacity: Optional[int] = None):
        self.sia = sia
        self.batcher = MicroBatcher(sia, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    persist_path=persist_path,
                                    max_streams=max_streams,
                                    stream_ttl_s=stream_ttl_s,
                                    pipeline=pipeline,
                                    pin_capacity=pin_capacity)
        handler = _make_handler(self.batcher, sia, request_timeout_s,
                                max_clip_seconds, max_ingest_seconds,
                                auth_token=auth_token)

        class _Server(ThreadingHTTPServer):
            # stdlib default backlog is 5: a burst of concurrent
            # connects (measured at 64 closed-loop clients against the
            # 95.3M-hash index) overflows the accept queue and the
            # kernel RSTs the excess — clients see ConnectionReset.
            request_queue_size = 128
            daemon_threads = True

        self.httpd = _Server((host, port), handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        try:
            self.httpd.serve_forever()
        finally:
            self.close()

    def install_signal_handlers(self, sigs=None) -> None:
        """SIGTERM/SIGINT -> graceful stop: stop accepting, let in-flight
        requests finish, return from ``serve_forever`` (whose cleanup
        drains the batcher).  ``httpd.shutdown()`` deadlocks if called
        from the thread running ``serve_forever``, and a signal handler
        runs exactly there — so the handler hands the shutdown to a
        helper thread."""
        import signal

        if sigs is None:
            sigs = (signal.SIGTERM, signal.SIGINT)

        def _handle(signum, frame):
            threading.Thread(target=self.httpd.shutdown, daemon=True,
                             name="sia-shutdown").start()

        for s in sigs:
            signal.signal(s, _handle)

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="sia-http")
        t.start()
        return t

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def warmup(sia, seconds: float = 5.0, max_batch: int = 16,
           clip_lengths=(), pair_buckets="auto",
           stream_window_seconds: float = 0.0,
           capacity_tiers=(), pin_capacity: Optional[int] = None) -> None:
    """Compile the serving programs before opening the listener.

    One clip per power-of-two batch size up to the pow2 CEILING of
    ``max_batch`` (the batcher pads every micro-batch to the next power
    of two, so a max_batch of 12 still dispatches shape 16), plus the
    single-query path: first requests then hit cached programs instead
    of paying the compile inside a request's latency budget.

    The warm clip is a synthetic SONG (dense constellation), so its
    query-pair count lands in the pow2 bucket typical music of that
    length uses.  But the match program's shape is the PAIR bucket, not
    the clip length: a sparse real clip (quiet audio, < 1024 pairs) or
    a denser-than-synthetic one lands in a neighboring bucket and would
    compile inside a live request.  ``pair_buckets`` closes that axis —
    "auto" warms 1024 (the floor every sparse clip hits) and 2x the
    largest warm clip's natural bucket; pass an explicit tuple of pow2
    bucket sizes to match a measured clip population, or ``()`` to skip.
    ``clip_lengths`` warms additional clip durations: each distinct
    length bucket a deployment accepts is a distinct fingerprint
    program, so warm every duration your clients send (or set
    ``max_clip_seconds`` to your policy and warm just that).

    ``capacity_tiers`` additionally compiles the batch programs at the
    given match-capacity tiers. Heavily duplicated catalogs escalate
    ~every batch past the base tier (the 95.3M tone build expands a
    typical 5 s clip to ~500K rows), and the escalated program
    otherwise compiles inside a live request. Warm the tier(s) your catalog actually hits
    (probe with one representative clip: `recognize_samples` reports
    `total_matches`); each (batch bucket × tier) is a separate
    compile, so warming all tiers blindly is expensive.

    ``pin_capacity`` mirrors a pinned server (``RecognitionServer(
    pin_capacity=...)``, serve_qps ``SERVE_PIN``): only the pinned
    tier's batch programs are compiled — exactly the live path's set.
    """
    from .audio.synth import synth_song

    fs = sia.config.sample_rate
    pow2_cap = 1
    while pow2_cap < max_batch:
        pow2_cap <<= 1
    if pin_capacity:
        # a pinned server (RecognitionServer(pin_capacity=...)) only
        # ever dispatches batches at the pinned tier — warm exactly that
        # program set: one compile per batch bucket, not (1 + n_tiers)
        capacity_tiers = (int(pin_capacity),)

    def warm(clip, q_pad_to=None):
        sia.recognize_samples([clip], q_pad_to=q_pad_to)
        # b=1 included: the batcher answers size-1 micro-batches via
        # recognize_batch as well, so the bq=1 programs (incl. each
        # capacity tier) must be warm for low-concurrency traffic.
        b = 1
        while b <= pow2_cap:
            if not pin_capacity:
                sia.recognize_batch([clip] * min(b, max_batch),
                                    pad_to_pow2=True, q_pad_to=q_pad_to)
            for cap in capacity_tiers:
                sia.recognize_batch([clip] * min(b, max_batch),
                                    pad_to_pow2=True, q_pad_to=q_pad_to,
                                    match_capacity=int(cap))
            b <<= 1

    naturals = set()
    for secs in (seconds, *clip_lengths):
        clip = synth_song(0, duration_s=secs + 1.0, seed=123)[: int(secs * fs)]
        clip = clip.astype(np.float32)
        n_pairs = sia.recognize_samples([clip])["input_hashes"]
        nat = 1024
        while nat < n_pairs:
            nat <<= 1
        naturals.add(nat)
        warm(clip)
    if pair_buckets == "auto":
        pair_buckets = (1024, 2 * max(naturals))
    # a silent clip yields zero pairs, so q_pad_to alone picks the
    # bucket — one fingerprint shape (already warm) covers any bucket
    silent = np.zeros(int(seconds * fs), np.float32)
    for qb in sorted(set(pair_buckets) - naturals):
        warm(silent, q_pad_to=qb)

    if stream_window_seconds > 0:
        # /stream sessions (host engine) run their own device programs:
        # pow2-bucketed spectrogram/settle slabs plus the edge strips.
        # Feed a few chunk sizes so the common buckets compile here, not
        # inside the first client's session; shapes are constant once the window passes ~1 s, so a
        # short synthetic stream covers steady state.
        from .stream import CHUNK, StreamRecognizer

        clip = synth_song(1, duration_s=stream_window_seconds + 2.0,
                          seed=321).astype(np.int16)
        # /stream/open exposes both engines; warm both so neither first
        # session compiles mid-stream. The device ring rejects windows
        # under its quantum minimum (~2.5 s) — skip it there.
        for eng in ("host", "device"):
            try:
                sr = StreamRecognizer(sia, channels=1,
                                      window_seconds=stream_window_seconds,
                                      engine=eng)
            except ValueError:
                continue
            pos = 0
            for step in (CHUNK // 2, CHUNK, 2 * CHUNK):
                sr.feed(clip[pos: pos + step])
                pos += step
            while pos + CHUNK <= len(clip):
                sr.feed(clip[pos: pos + CHUNK])
                pos += CHUNK
            sr.recognize()
            sr.recognize()  # second call warms the settled-strip shapes

"""Command-line interface: ingest / recognize / bench / stats / sanity /
plot / synth.

The reference drives everything through per-script ``__main__`` blocks
with hand-edited config constants (``__init__.py:417-432``,
``recognizer.py:355-398``, ``recognizer_test.py:516-614``); here the same
workflows are argparse subcommands over one persistent catalog+index pair
(--db PREFIX -> PREFIX.sqlite + PREFIX.npz).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _open_sia(args, need_index: bool):
    from .api import SIA
    from .config import FingerprintConfig

    config = FingerprintConfig()
    if getattr(args, "config", None):
        with open(args.config) as fh:
            config = FingerprintConfig.from_json(fh.read())
    sia = SIA(config=config, catalog_path=args.db + ".sqlite",
              device_resident=getattr(args, "device_resident", False),
              device_span_rows=getattr(args, "span_rows", 0) or 0)
    index_path = args.db + ".npz"
    if os.path.exists(index_path):
        sia.load_index(index_path)
    elif need_index:
        sys.exit(f"no index at {index_path}; run `ingest` first")
    return sia


def cmd_ingest(args):
    sia = _open_sia(args, need_index=False)
    stats = sia.ingest_directory(
        args.path,
        extensions=args.extensions.split(","),
        limit=args.limit,
        batch_size=args.batch_size,
        verbose=True,
    )
    sia.save_index(args.db + ".npz")
    print(json.dumps(stats, default=str))


def cmd_recognize(args):
    sia = _open_sia(args, need_index=True)
    out = sia.recognize_file(args.file, limit=args.limit, topn=args.topn,
                             early_exit=args.early_exit)
    print(json.dumps(out, default=str, indent=2))
    if out["results"]:
        top = out["results"][0]
        md = sia.get_metadata(_maybe_int(top["song_name"]))
        if md:
            print("metadata:", json.dumps(md))


def _maybe_int(name):
    try:
        return int(name)
    except (TypeError, ValueError):
        return -1


def cmd_bench(args):
    from .audio.io import find_files
    from .bench.harness import BenchConfig, run_recognition_sweep

    sia = _open_sia(args, need_index=True)
    songs = sorted(p for p, _ in find_files(args.path, args.extensions.split(",")))
    if args.limit_songs:
        songs = songs[: args.limit_songs]
    cfg = BenchConfig(
        record_seconds=args.seconds,
        add_noise=args.snr is not None,
        snr_db=args.snr if args.snr is not None else 0.0,
        noise_kind="awgn" if args.awgn else "file",
        noise_file=args.noise_file,
        channel=args.channel,
        channel_severity=args.channel_severity,
        topn=args.topn,
        seed=args.seed,
        out_dir=args.out_dir,
    )
    summary = run_recognition_sweep(sia, songs, cfg)
    summary.pop("predicted", None)
    print(json.dumps(summary, default=str, indent=2))


def cmd_stats(args):
    from .tools.stats import dump_song_hash_stats

    sia = _open_sia(args, need_index=False)
    out = dump_song_hash_stats(sia.catalog, csv_path=args.out)
    out["index_hashes"] = sia.index.n_hashes
    print(json.dumps(out, default=str, indent=2))


def cmd_fsck(args):
    from .tools.fsck import check_integrity

    sia = _open_sia(args, need_index=True)
    report = check_integrity(sia, deep=not args.fast)
    print(json.dumps(report, default=str, indent=2))
    if not report["ok"]:
        sys.exit(1)


def cmd_sanity(args):
    from .audio.io import find_files
    from .tools.sanity import check_corpus_sanity

    files = [p for p, _ in find_files(args.path, args.extensions.split(","))]
    out = check_corpus_sanity(files, record_seconds=args.seconds,
                              delete=args.delete)
    print(json.dumps(out, default=str, indent=2))


def cmd_plot(args):
    from .audio.io import read
    from .config import FingerprintConfig
    from .tools.plot import plot_constellation

    # honor --config: the plot must show the peaks the PIPELINE extracts
    cfg = FingerprintConfig()
    if getattr(args, "config", None):
        with open(args.config) as fh:
            cfg = FingerprintConfig.from_json(fh.read())
    channels, fs, _ = read(args.file, limit=args.limit)
    path = plot_constellation(
        channels[0], args.out, fs=fs, amp_min=cfg.amp_min,
        radius=cfg.peak_neighborhood_size,
        title=os.path.basename(args.file))
    print(json.dumps({"plot": path}))


def cmd_listen(args):
    """One-shot mic recognition (reference recognizer.py main path)."""
    from .stream import recognize_from_mic

    sia = _open_sia(args, need_index=True)
    out = recognize_from_mic(sia, seconds=args.seconds,
                             channels=args.channels, topn=args.topn)
    print(json.dumps(out, default=str, indent=2))


def cmd_metadata(args):
    sia = _open_sia(args, need_index=False)
    n = sia.catalog.import_metadata_csv(args.csv)
    print(json.dumps({"imported": n}))


def cmd_serve(args):
    from .serve import RecognitionServer, warmup

    sia = _open_sia(args, need_index=True)
    if args.consolidate:
        sia.consolidate_index()
    if args.warmup:
        print("warming serving programs...", flush=True)
        extra = [float(s) for s in args.warm_lengths.split(",") if s] \
            if args.warm_lengths else []
        tiers = [int(s) for s in args.warm_tiers.split(",") if s] \
            if args.warm_tiers else []
        warmup(sia, seconds=args.warmup, max_batch=args.max_batch,
               clip_lengths=extra,
               stream_window_seconds=args.warm_stream,
               capacity_tiers=tiers,
               pin_capacity=args.pin_tier or None)
    server = RecognitionServer(
        sia, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        request_timeout_s=args.request_timeout,
        max_clip_seconds=args.max_clip_seconds,
        max_ingest_seconds=args.max_ingest_seconds,
        persist_path=(args.db + ".npz") if args.persist else None,
        max_streams=args.max_streams, stream_ttl_s=args.stream_ttl,
        auth_token=args.auth_token or os.environ.get("SHAZAM_SERVE_TOKEN"),
        pipeline=not args.no_pipeline,
        pin_capacity=args.pin_tier or None,
    )
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "songs": sia.catalog.counts()["n_songs"],
                      "hashes": sia._live_n_hashes()}), flush=True)
    server.install_signal_handlers()  # SIGTERM/SIGINT -> graceful stop
    server.serve_forever()
    print(json.dumps({"stopped": True, **server.batcher.stats}), flush=True)


def cmd_synth(args):
    from .audio.synth import synth_corpus

    files = synth_corpus(args.path, args.n, duration_s=args.seconds,
                         seed=args.seed)
    print(json.dumps({"generated": len(files), "dir": args.path}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shazam-tpu",
                                description="accelerator-native audio fingerprinting")
    p.add_argument("--db", default="sia_catalog",
                   help="catalog prefix (PREFIX.sqlite + PREFIX.npz)")
    p.add_argument("--config", default=None, help="FingerprintConfig JSON file")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("ingest", help="fingerprint a folder into the index")
    s.add_argument("path")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--limit", type=float, default=None,
                   help="seconds per file to fingerprint")
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--device-resident", action="store_true",
                   help="merge fingerprints on the device (index/devmerge"
                        ".py) — for catalogs where host merges dominate")
    s.add_argument("--span-rows", type=int, default=0,
                   help="hold the index as bounded sorted spans of this "
                        "many rows (implies --device-resident; for "
                        "catalogs past ~150M hashes, e.g. 1<<27 = "
                        "134217728 — see index/devmerge"
                        ".SpannedDeviceStore)")
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser("recognize", help="identify one audio file")
    s.add_argument("file")
    s.add_argument("--limit", type=float, default=None)
    s.add_argument("--topn", type=int, default=2)
    s.add_argument("--early-exit", action="store_true")
    s.add_argument("--device-resident", action="store_true",
                   help="serve the index from device HBM")
    s.add_argument("--span-rows", type=int, default=0,
                   help="serve as bounded sorted spans (implies "
                        "--device-resident; required past ~150M hashes)")
    s.set_defaults(fn=cmd_recognize)

    s = sub.add_parser("bench", help="recognition accuracy/latency sweep")
    s.add_argument("path", help="corpus folder")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--snr", type=float, default=None,
                   help="mix noise at this SNR (dB)")
    s.add_argument("--awgn", action="store_true", help="use AWGN noise")
    s.add_argument("--noise-file", default=None)
    s.add_argument("--channel", action="store_true",
                   help="pass query clips through the synthetic acoustic "
                        "loop (speaker band-limit, room reverb, soft clip, "
                        "noise floor — audio/channel.py)")
    s.add_argument("--channel-severity", type=float, default=1.0,
                   help="how harsh the channel draws are: 1.0 = stress "
                        "rig (default), audio.channel.CALIBRATED_SEVERITY "
                        "matches the reference's real loopback band")
    s.add_argument("--topn", type=int, default=3)
    s.add_argument("--seed", type=int, default=1234)
    s.add_argument("--out-dir", default="bench_out")
    s.add_argument("--limit-songs", type=int, default=None)
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("stats", help="dump per-song hash stats CSV")
    s.add_argument("--out", default="song_hashes.csv")
    s.set_defaults(fn=cmd_stats)

    s = sub.add_parser(
        "fsck", help="validate index/catalog integrity invariants")
    s.add_argument("--fast", action="store_true",
                   help="skip the per-song row-count reconcile")
    s.set_defaults(fn=cmd_fsck)

    s = sub.add_parser("sanity", help="validate corpus decodability/length")
    s.add_argument("path")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--delete", action="store_true")
    s.set_defaults(fn=cmd_sanity)

    s = sub.add_parser("plot", help="render spectrogram + constellation PNG")
    s.add_argument("file")
    s.add_argument("--out", default="constellation.png")
    s.add_argument("--limit", type=float, default=None)
    s.set_defaults(fn=cmd_plot)

    s = sub.add_parser("listen", help="record from the microphone and identify")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--channels", type=int, default=2)
    s.add_argument("--topn", type=int, default=2)
    s.set_defaults(fn=cmd_listen)

    s = sub.add_parser("metadata", help="bulk-import FMA-style metadata CSV")
    s.add_argument("csv")
    s.set_defaults(fn=cmd_metadata)

    s = sub.add_parser(
        "serve",
        help="HTTP recognition daemon (micro-batched device dispatches)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--max-batch", type=int, default=16,
                   help="largest micro-batch per device dispatch")
    s.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="how long the first request waits for companions")
    s.add_argument("--no-pipeline", action="store_true",
                   help="disable the two-stage fingerprint/match "
                        "pipeline (one batch in flight at a time)")
    s.add_argument("--warmup", type=float, default=5.0, metavar="SECONDS",
                   help="pre-compile serving programs with clips this long "
                        "(0 disables)")
    s.add_argument("--warm-lengths", default="", metavar="S1,S2,...",
                   help="additional clip durations to pre-compile (each "
                        "distinct length bucket is a distinct program)")
    s.add_argument("--warm-stream", type=float, default=0.0,
                   metavar="WINDOW_SECONDS",
                   help="also pre-compile the /stream session programs "
                        "for this window length (0 disables; match the "
                        "window your streaming clients open)")
    s.add_argument("--warm-tiers", default="", metavar="CAP1,CAP2,...",
                   help="also pre-compile batch programs at these match-"
                        "capacity tiers (heavily duplicated catalogs "
                        "escalate every batch; without this the "
                        "escalated program compiles inside a live "
                        "request)")
    s.add_argument("--pin-tier", type=int, default=0, metavar="CAP",
                   help="dispatch every micro-batch at this match-"
                        "capacity tier (one compiled program per batch "
                        "bucket — the bounds probe still runs and per-"
                        "clip escalation still covers outliers); probe "
                        "a representative clip's total_matches and pin "
                        "the tier above it")
    s.add_argument("--request-timeout", type=float, default=600.0,
                   help="seconds a request waits for its result (cover a "
                        "cold compile)")
    s.add_argument("--max-clip-seconds", type=float, default=60.0,
                   help="reject clips longer than this before any device "
                        "work (each new length bucket compiles a program)")
    s.add_argument("--max-ingest-seconds", type=float, default=600.0,
                   help="reject POST /ingest songs longer than this")
    s.add_argument("--max-streams", type=int, default=8,
                   help="concurrent /stream sessions (each holds a "
                        "window of incremental fingerprint state)")
    s.add_argument("--stream-ttl", type=float, default=300.0,
                   help="seconds of inactivity before a /stream session "
                        "is evicted")
    s.add_argument("--persist", action="store_true",
                   help="save the index after every online ingest (full "
                        "rewrite per song; without it, rows ingested via "
                        "POST /ingest live only in this process and the "
                        "next load purges their catalog entries)")
    s.add_argument("--device-resident", action="store_true",
                   help="serve the index from device HBM")
    s.add_argument("--span-rows", type=int, default=0,
                   help="serve as bounded sorted spans (implies "
                        "--device-resident; required past ~150M hashes)")
    s.add_argument("--consolidate", action="store_true",
                   help="stack spanned stores into the vmapped serving "
                        "layout (faster queries; the store becomes "
                        "read-only)")
    s.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on "
                        "catalog mutations (/ingest, /delete, /save); "
                        "prefer the SHAZAM_SERVE_TOKEN env var to keep "
                        "the secret out of the process list")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("synth", help="generate a deterministic WAV corpus")
    s.add_argument("path")
    s.add_argument("-n", type=int, default=10)
    s.add_argument("--seconds", type=float, default=30.0)
    s.add_argument("--seed", type=int, default=1234)
    s.set_defaults(fn=cmd_synth)

    return p


def main(argv=None):
    # persistent XLA compile cache: CLI invocations are separate
    # processes; without it every run re-pays its compiles
    from .runtime import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

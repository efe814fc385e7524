"""Validate the music-like corpus generator against real-music statistics.

The reference's robustness numbers are all on real music (reference
``tests_csv/shazam_results_31-10-2020__01-59-55_100records.csv``: 0.96
clean @ 100 songs / 5 s clips; ``shazam_results_100records_5sec_0SNR.csv``:
0.8119 @ 0 dB). Our original percussive-tone corpus collapses under AWGN
at scale (0.44 @ 0 dB — broadband click constellations drown), so nothing
showed the *pipeline* matches the reference's robustness. This bench
validates ``synth_music_song`` two ways:

1. hash density ~= 11-12K unique hashes / 210 s track (reference
   ``songs_queries.sql:11``) — checked via the ingest stats;
2. an SNR degradation curve at 100 songs x 210 s whose shape matches the
   reference's real-music curve (high-but-imperfect clean accuracy,
   graceful degradation to ~0.8 at 0 dB SNR) rather than the tonal
   corpus's 1.00-everywhere or the click corpus's collapse.

Once this passes, the full-catalog sweep (catalog_music.py) carries the
validated corpus to 2,714 x 210 s — the reference's headline scale.

Usage: python benchmarks/music_snr_validation.py [n_songs] [duration_s]
JAX_PLATFORMS=cpu works for small smoke runs.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
TMP = tempfile.gettempdir()

from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_corpus
from shazam_tpu.bench.harness import BenchConfig, run_recognition_sweep


def main() -> None:
    n_songs = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    duration = float(sys.argv[2]) if len(sys.argv) > 2 else 210.0

    t0 = time.time()
    files = [f for f, _ in synth_corpus(
        os.path.join(TMP, "corpus_music"), n_songs, duration_s=duration, seed=2026,
        style="music")]
    print(f"corpus: {n_songs} x {duration:.0f}s music songs "
          f"({time.time()-t0:.0f}s)", flush=True)

    sia = SIA(catalog_path=os.path.join(TMP, "music_snr.sqlite"))
    t0 = time.time()
    sia.ingest_files(files, batch_size=16)
    n_hashes = sia._live_n_hashes()
    density = n_hashes / n_songs
    print(json.dumps({
        "n_songs": n_songs, "duration_s": duration,
        "n_hashes": int(n_hashes),
        "hashes_per_song": round(density, 1),
        "target_density": "11000-12000 @ 210s (songs_queries.sql:11)",
        "ingest_s": round(time.time() - t0, 1),
    }), flush=True)

    # The reference's exact noise source: the city-traffic MP3 its 0.8119
    # @ 0 dB figure used (recognizer_test.py:426-435) — decodable here via
    # libmpg123 (path in SNR_CITY_MP3; not part of this repository);
    # AWGN sweeps run alongside for the synthetic comparison.
    city = os.environ.get("SNR_CITY_MP3", "")
    modes = [("clean", None, None)] + \
        [(f"awgn_{s:g}dB", s, None) for s in (20.0, 10.0, 5.0, 0.0, -5.0)]
    if city and os.path.exists(city):
        modes += [(f"city_{s:g}dB", s, city) for s in (10.0, 5.0, 0.0)]
    modes.append(("acoustic_channel", None, "channel"))

    curve = {}
    for key, snr, noise_file in modes:
        cfg = BenchConfig(
            record_seconds=5.0,
            add_noise=snr is not None,
            snr_db=snr if snr is not None else 0.0,
            noise_kind="file" if (noise_file and noise_file != "channel")
            else "awgn",
            noise_file=noise_file if noise_file != "channel" else None,
            channel=noise_file == "channel",
            out_dir=os.path.join(TMP, f"music_snr_{key}"),
            seed=99, checkpoints=False)
        t0 = time.time()
        s = run_recognition_sweep(sia, files, cfg)
        curve[key] = s["accuracy"]
        print(json.dumps({
            "mode": key,
            "accuracy": s["accuracy"],
            "p50_total_time": round(s["p50_total_time"], 4),
            "seconds": round(time.time() - t0, 1),
        }), flush=True)

    print(json.dumps({
        "curve": curve,
        "reference_curve": {"clean": 0.96, "0dB_city_traffic": 0.8119},
    }), flush=True)


if __name__ == "__main__":
    main()

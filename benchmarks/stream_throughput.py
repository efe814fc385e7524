"""Continuous-listening throughput: concurrent incremental sessions.

The reference's capture loop refingerprints the whole window per
recognition (``recognizer.py:355-382``), so continuous listening costs
window_seconds of STFT per poll. The incremental engines
(``stream.py`` host columns / ``stream_device.py`` HBM ring) do device
work proportional to NEW audio only — this bench quantifies that as the
number of real-time audio streams one chip can follow while polling
recognition at a fixed cadence.

Protocol: K sessions round-robin 1 s chunks of distinct catalog songs;
every POLL seconds of audio each session recognizes its window. Wall
time to push T seconds of audio through all K sessions gives
realtime_factor = K * T / wall — how many live streams the chip
sustains. A full-recompute control (incremental=False) runs the same
schedule for the speedup column. Accuracy is asserted per poll.

Timings are wall-clock (every feed/recognize is a dispatch with a host
round trip; there is no chained-loop protocol for stateful streams) —
the realtime factor is therefore a LOWER bound on the device's
capability and an honest number for a deployment.

Env knobs:
  STREAM_SONGS     catalog size (default 32)
  STREAM_DUR       catalog song seconds (default 30)
  STREAM_SESSIONS  concurrent sessions (default 8)
  STREAM_SECONDS   audio seconds fed per session (default 20)
  STREAM_WINDOW    recognition window seconds (default 10)
  STREAM_POLL      recognize every this many audio seconds (default 2)
  STREAM_ENGINE    host | device (default device)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SONGS = int(os.environ.get("STREAM_SONGS", 32))
DUR = float(os.environ.get("STREAM_DUR", 30.0))
SESSIONS = int(os.environ.get("STREAM_SESSIONS", 8))
SECONDS = float(os.environ.get("STREAM_SECONDS", 20.0))
WINDOW = float(os.environ.get("STREAM_WINDOW", 10.0))
POLL = float(os.environ.get("STREAM_POLL", 2.0))
ENGINE = os.environ.get("STREAM_ENGINE", "device")
FS = 44100


def _run_schedule(recs, clips, incremental):
    """Feed 1 s chunks round-robin; recognize every POLL audio-seconds.
    Returns (wall_seconds, polls, correct)."""
    chunk = FS
    n_chunks = int(SECONDS)
    polls = correct = 0
    t0 = time.time()
    for step in range(n_chunks):
        for s, rec in enumerate(recs):
            rec.feed(clips[s][step * chunk: (step + 1) * chunk])
        if (step + 1) % int(POLL) == 0 and (step + 1) * 1.0 >= min(
                WINDOW / 2, SECONDS):
            for s, rec in enumerate(recs):
                out = rec.recognize(incremental=incremental)
                polls += 1
                if out["results"] and \
                        out["results"][0]["song_name"] == f"t{s % SONGS}":
                    correct += 1
    return time.time() - t0, polls, correct


def main():
    from shazam_tpu import SIA
    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.stream import StreamRecognizer

    sia = SIA()
    songs = [(f"t{i}", synth_song(i, duration_s=DUR, seed=91))
             for i in range(SONGS)]
    sia.ingest_arrays(songs)

    clips = []
    for s in range(SESSIONS):
        src = np.asarray(songs[s % SONGS][1], np.int16)
        start = int(1.0 * FS) + (s // SONGS) * int(2.0 * FS)
        clip = src[start: start + int(SECONDS * FS)]
        if len(clip) < int(SECONDS * FS):   # wrap for long schedules
            reps = -(-int(SECONDS * FS) // len(clip))
            clip = np.tile(clip, reps)[: int(SECONDS * FS)]
        clips.append(clip)

    def sessions():
        return [StreamRecognizer(sia, channels=1, window_seconds=WINDOW,
                                 engine=ENGINE) for _ in range(SESSIONS)]

    # warm both paths (compiles dominate first runs)
    warm = sessions()
    _run_schedule(warm, clips, incremental=True)
    _run_schedule(warm, clips, incremental=False)

    wall_inc, polls, correct = _run_schedule(sessions(), clips,
                                             incremental=True)
    wall_full, polls_f, correct_f = _run_schedule(sessions(), clips,
                                                  incremental=False)
    assert polls and correct == polls, (correct, polls)
    assert correct_f == polls_f, (correct_f, polls_f)

    audio_seconds = SESSIONS * SECONDS
    print(json.dumps({
        "engine": ENGINE,
        "sessions": SESSIONS,
        "window_seconds": WINDOW,
        "poll_every_audio_s": POLL,
        "audio_seconds_total": audio_seconds,
        "wall_s_incremental": round(wall_inc, 3),
        "wall_s_full_recompute": round(wall_full, 3),
        "realtime_streams_incremental": round(audio_seconds / wall_inc, 2),
        "realtime_streams_full_recompute": round(audio_seconds / wall_full, 2),
        "incremental_speedup": round(wall_full / wall_inc, 2),
        "polls": polls,
        "accuracy": correct / polls,
    }))


if __name__ == "__main__":
    main()

import os, sys, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax
from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_song

N = 2714
DUR = 15.0
sia = SIA()

t0 = time.time()
gen_t = 0.0
batch = []
for i in range(N):
    tg = time.time()
    s = synth_song(i, duration_s=DUR, seed=777)
    gen_t += time.time() - tg
    batch.append((f"track{i:06d}", s))
    if len(batch) == 64 or i == N - 1:
        sia.ingest_arrays(batch, batch_size=16)
        batch = []
    if (i + 1) % 500 == 0:
        print(f"ingested {i+1}/{N} ({time.time()-t0:.0f}s, synth {gen_t:.0f}s)", flush=True)
print(f"ingest done: {sia.index.n_hashes} hashes, {sia.index.n_songs} songs, "
      f"{time.time()-t0:.0f}s total ({gen_t:.0f}s host synth)", flush=True)

# recognition sweep over 300 sampled songs, 5 s clips, random starts
rng = np.random.default_rng(5)
picks = rng.choice(N, 300, replace=False)
correct = 0
times = []
t0 = time.time()
for j, sid in enumerate(picks):
    song = synth_song(int(sid), duration_s=DUR, seed=777)
    start = int(rng.integers(0, int((DUR - 5) * 44100)))
    clip = song[start:start + 5 * 44100]
    out = sia.recognize_samples([clip])
    if out["results"] and out["results"][0]["song_name"] == f"track{sid:06d}":
        correct += 1
    times.append(out["query_time"])
    if (j + 1) % 100 == 0:
        print(f"  swept {j+1}/300, acc so far {correct/(j+1):.4f}", flush=True)
print(json.dumps({
    "config": "2714 tracks, 15s songs, 5s clips, 300 samples",
    "accuracy": correct / 300,
    "index_hashes": sia.index.n_hashes,
    "query_p50_s": float(np.percentile(times, 50)),
    "sweep_seconds": round(time.time() - t0, 1),
}), flush=True)

import os, tempfile, sys, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax
from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
TMP = tempfile.gettempdir()
from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_corpus
from shazam_tpu.bench.harness import BenchConfig, run_recognition_sweep

files = [f for f, _ in synth_corpus(os.path.join(TMP, 'corpus100'), 100, duration_s=30.0, seed=2026)]
sia = SIA(catalog_path=os.path.join(TMP, 'snr100.sqlite'))
t0=time.time()
sia.ingest_files(files, batch_size=16)
print('ingest done', round(time.time()-t0,1), flush=True)

for snr in (20.0, 10.0, 5.0, 0.0, -5.0):
    cfg = BenchConfig(record_seconds=5.0, add_noise=True, snr_db=snr,
                      noise_kind='awgn', out_dir=os.path.join(TMP, f'snr_{snr:g}'),
                      seed=99, checkpoints=False)
    t0=time.time()
    s = run_recognition_sweep(sia, files, cfg)
    print(json.dumps({'snr_db': snr, 'accuracy': s['accuracy'],
                      'p50_total_time': round(s['p50_total_time'],4),
                      'seconds': round(time.time()-t0,1)}), flush=True)

import os, tempfile, sys, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from shazam_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
TMP = tempfile.gettempdir()
from shazam_tpu import SIA
from shazam_tpu.audio.synth import synth_corpus
from shazam_tpu.bench.harness import BenchConfig, run_recognition_sweep

t0 = time.time()
files = [f for f, _ in synth_corpus(os.path.join(TMP, 'corpus100'), 100, duration_s=30.0, seed=2026)]
print('corpus ready', time.time()-t0, flush=True)

sia = SIA(catalog_path=os.path.join(TMP, 'corpus100.sqlite'))
t0 = time.time()
stats = sia.ingest_files(files, batch_size=16)
print('ingest:', json.dumps({k: v for k, v in stats.items() if k != 'overflowed'}), 
      'overflowed:', len(stats['overflowed']), flush=True)

for name, cfg in [
    ('clean', BenchConfig(record_seconds=5.0, out_dir=os.path.join(TMP, 'acc_clean'), seed=99, checkpoints=False)),
    ('awgn0db', BenchConfig(record_seconds=5.0, add_noise=True, snr_db=0.0,
                            noise_kind='awgn', out_dir=os.path.join(TMP, 'acc_noise'), seed=99, checkpoints=False)),
]:
    t0 = time.time()
    s = run_recognition_sweep(sia, files, cfg)
    print(name, json.dumps({
        'accuracy': s['accuracy'], 'correct': s['correct'], 'n': s['n'],
        'p50_total_time': round(s['p50_total_time'], 4),
        'sweep_seconds': round(time.time()-t0, 1),
    }), flush=True)

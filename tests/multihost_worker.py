"""Worker for the 2-process multi-host catalog tests (run via subprocess).

Usage: python multihost_worker.py <process_id> <port> [ingest <tmpdir>]
Mode 1 (default): both processes build the SAME deterministic index,
keep only their own devices' song shards, and answer a query whose
exact result is known by construction. Prints MULTIHOST_OK on success.
Mode 2 (ingest): each process fingerprints ONLY its own shards' songs
(distributed_ingest_arrays), the spanned catalog answers a clip query,
and the per-process shard files round-trip. Prints INGEST_OK.
"""

import os
import sys


def _ingest_mode(tmpdir: str) -> None:
    """Distributed ingest: the fingerprint work itself is process-sharded."""
    import jax
    import numpy as np

    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.match.prepare import prepare_query
    from shazam_tpu.ops.fingerprint import fingerprint_samples
    from shazam_tpu.parallel.multihost import (
        SpannedCatalog, distributed_ingest_arrays, global_mesh,
    )

    n_songs, dur = 8, 2.5
    names = [f"track{s:03d}" for s in range(n_songs)]
    loads = []

    def load(s: int) -> np.ndarray:
        loads.append(s)
        # song 6 is a byte-identical duplicate of song 4, in a LATER
        # ingest chunk (chunk_songs=2): the local SHA-1 resume dedup
        # skips it and the id remap must tolerate the missing name
        # (regression: KeyError after all fingerprinting was done)
        return synth_song(4 if s == 6 else s, duration_s=dur)

    mesh = global_mesh()
    cat, local = distributed_ingest_arrays(names, load, mesh=mesh,
                                           batch_size=4, chunk_songs=2)
    # this process fingerprinted ONLY its own shards' songs
    mine = set(cat._my_shard_ids())
    assert set(loads) == {s for s in range(n_songs)
                          if s % cat.n_shards in mine}, (loads, mine)
    assert len(loads) < n_songs
    assert {d["song_name"] for d in local.catalog.get_songs()} == {
        names[s] for s in loads if s != 6
    }

    # a clip from song 5 must win the spanned query on every process
    target = 5
    fs = 44100
    clip = np.asarray(synth_song(target, duration_s=dur))[
        int(0.4 * fs): int(1.9 * fs)
    ]
    pad = np.zeros(1 << 18, np.float32)
    pad[: len(clip)] = clip  # raw sample values, same as the ingest path
    fp = fingerprint_samples(pad, np.int32(len(clip)))
    q = prepare_query([jax.device_get(fp)])
    res = cat.match(q, topn=2, q_frames=1024)
    top = res.results[0]
    assert top["song_id"] == target, res.results
    assert top["hashes_matched_in_input"] > 10

    # per-process shard-file persistence round trip
    cat.save_local_shards(tmpdir)
    cat2 = SpannedCatalog.load_local_shards(tmpdir, mesh=mesh)
    res2 = cat2.match(q, topn=2, q_frames=1024)
    assert res2.results[0]["song_id"] == target
    assert (res2.results[0]["hashes_matched_in_input"]
            == top["hashes_matched_in_input"])
    print(f"INGEST_OK pid={jax.process_index()} owned={sorted(loads)} "
          f"votes={top['hashes_matched_in_input']}", flush=True)


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shazam_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from shazam_tpu.parallel.multihost import (
        SpannedCatalog, global_mesh, init_multihost,
    )

    init_multihost(f"localhost:{port}", num_processes=2, process_id=pid,
                   local_device_count=4)
    assert jax.device_count() == 8
    assert jax.local_device_count() == 4

    if len(sys.argv) > 3 and sys.argv[3] == "ingest":
        _ingest_mode(sys.argv[4])
        return

    # deterministic synthetic index: 4000 songs, unique keys by bit-mix,
    # plus a planted song with known rows (same recipe on both processes)
    from shazam_tpu.index.store import FingerprintIndex, _sort_entries

    # >= 4096 rows/shard so per-shard bucket-CDF heads build and the
    # spanned query exercises the head-seeded search across processes
    n_songs, rows_per = 4000, 10
    n = n_songs * rows_per
    z = (np.arange(n, dtype=np.uint64) + np.uint64(11)) * np.uint64(
        0xBF58476D1CE4E5B9
    )
    z ^= z >> np.uint64(27)
    hi = (z >> np.uint64(32)).astype(np.uint32) | np.uint32(0x80000000)
    lo = z.astype(np.uint32)
    ex = (z & np.uint64(0x7FFF)).astype(np.uint32)
    sid = np.repeat(np.arange(n_songs, dtype=np.uint32), rows_per)
    off = (z % np.uint64(3000)).astype(np.uint32)

    planted_sid = 3777
    n_plant = 60
    p_hi = np.arange(n_plant, dtype=np.uint32)  # < 0x80000000: no collision
    p_lo = p_hi * np.uint32(77)
    p_ex = p_hi & np.uint32(0xFF)
    p_off = np.uint32(500) + np.arange(n_plant, dtype=np.uint32)
    cols = _sort_entries(
        np.concatenate([hi, p_hi]), np.concatenate([lo, p_lo]),
        np.concatenate([ex, p_ex]),
        np.concatenate([sid, np.full(n_plant, planted_sid, np.uint32)]),
        np.concatenate([off, p_off]),
    )
    index = FingerprintIndex(*cols, n_songs=n_songs, max_offset=3000)

    mesh = global_mesh()
    cat = SpannedCatalog.from_full_index(index, mesh=mesh)

    # query the planted song at a uniform shift of 13 frames
    from shazam_tpu.match.prepare import QueryPairs

    t = (p_off - np.uint32(13)).astype(np.uint32)
    order = np.lexsort((t, p_ex, p_lo, p_hi))
    cap, pad = 128, 128 - n_plant
    q = QueryPairs(
        np.pad(p_hi[order], (0, pad)), np.pad(p_lo[order], (0, pad)),
        np.pad(p_ex[order], (0, pad)), np.pad(t[order], (0, pad)),
        np.pad(np.ones(n_plant, bool), (0, pad)),
        np.pad(np.ones(n_plant, bool), (0, pad)),
        n_plant,
    )
    res = cat.match(q, topn=3, q_frames=1024)
    top = res.results[0]
    assert top["song_id"] == planted_sid, res.results
    assert top["hashes_matched_in_input"] == n_plant
    assert top["offset"] == 13
    assert res.total_matches == n_plant
    print(f"MULTIHOST_OK pid={pid} top={top['song_id']} "
          f"votes={top['hashes_matched_in_input']}", flush=True)


if __name__ == "__main__":
    main()

"""Every device entry point that fingerprints audio agrees with the float64
oracle at the full 4096-sample window: the ingest path's index rows, the
single-dispatch query paths' on-device query pairs, and their ranked
answers against ``oracle_align`` over the same index rows.

Bounds: hash sets at Jaccard > 0.98 (``test_dsp_parity``'s float32 vs
float64 bound); top-1 song and offset exact; counts within 2% (a float32
peak flip moves a handful of hashes, never the answer).
"""

import numpy as np
import pytest

from tests.oracle import oracle_align, oracle_fingerprint

FS = 44100
ENTRIES = ("ingest_device_batch", "recognize_clip",
           "fingerprint_probe_on_device", "recognize_on_device_spanned")


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


@pytest.fixture(scope="module")
def catalog():
    import jax.numpy as jnp

    from shazam_tpu.api import SIA
    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.ops.sha1 import keys_to_hex

    songs = [synth_song(i, duration_s=8.0, seed=31) for i in range(3)]
    n = len(songs[0])
    blen = -(-n // (1 << 18)) * (1 << 18)
    mat = np.zeros((3, blen), np.float32)
    for i, s in enumerate(songs):
        mat[i, :n] = s
    sia = SIA(device_resident=True)
    st = sia.ingest_device_batch(["s0", "s1", "s2"], jnp.asarray(mat),
                                 [n] * 3)
    assert st["ingested"] == 3
    ix = sia.index
    hexes = keys_to_hex(ix.key_hi, ix.key_lo, ix.key_ex)
    rows = {}
    for h, sid, off in zip(hexes, ix.song_id.tolist(), ix.offset.tolist()):
        rows.setdefault(h.upper(), []).append((int(sid), int(off)))
    sid1 = next(s["song_id"] for s in sia.catalog.get_songs()
                if s["song_name"] == "s1")
    clip = songs[1][2 * FS: 7 * FS]
    return dict(sia=sia, songs=songs, ix=ix, hexes=hexes, rows=rows,
                sid1=sid1, clip=clip,
                clip_ref=set(oracle_fingerprint(clip)))


def _device_query_pairs(cat):
    import jax
    import jax.numpy as jnp

    from shazam_tpu.match.ondevice import fingerprint_probe_on_device
    from shazam_tpu.ops.sha1 import keys_to_hex

    sia, clip = cat["sia"], cat["clip"]
    padded = np.zeros(1 << 18, np.float32)
    padded[: len(clip)] = clip
    q_dev, n_pairs, *_ = jax.device_get(fingerprint_probe_on_device(
        jnp.asarray(padded)[None, :], jnp.asarray([len(clip)], np.int32),
        sia._ensure_device_index(), **sia._fp_kwargs(),
        query_capacity=4096))
    hi, lo, ex, t1, valid, _first = (np.asarray(a) for a in q_dev)
    pairs = set(zip((h.lower() for h in keys_to_hex(hi[valid], lo[valid],
                                                     ex[valid])),
                    t1[valid].astype(int).tolist()))
    assert len(pairs) == int(n_pairs)
    return pairs


def _spanned_raw(cat):
    import jax
    import jax.numpy as jnp

    from shazam_tpu.index.devmerge import SpannedDeviceStore
    from shazam_tpu.index.search import maybe_build_head
    from shazam_tpu.match.ondevice import recognize_on_device_spanned
    from shazam_tpu.match.prepare import q_frames_for_max_offset

    sia, clip, ix = cat["sia"], cat["clip"], cat["ix"]
    store = SpannedDeviceStore.from_host(ix, span_rows=4096)
    cols = store.query_cols()
    assert len(cols) >= 2, "the catalog should span several spans"
    q_frames = q_frames_for_max_offset(
        (len(clip) - sia.config.window_size) // sia.config.hop)
    padded = np.zeros(1 << 18, np.float32)
    padded[: len(clip)] = clip
    raw, _span_max, n_pairs, _n_peaks, _n_hashes = jax.device_get(
        recognize_on_device_spanned(
            jnp.asarray(padded)[None, :], jnp.asarray([len(clip)], np.int32),
            cols, **sia._fp_kwargs(), n_songs=ix.n_songs,
            delta_min=-q_frames,
            delta_range=((ix.max_offset // 4096) + 1) * 4096 + 2 * q_frames,
            match_capacity=16384, topn=2, offset_stride=store.stride,
            query_capacity=4096,
            heads=tuple(maybe_build_head(c[0]) for c in cols)))
    return (int(raw.top_songs[0]), int(raw.top_deltas[0]),
            int(raw.row_counts[0]), int(n_pairs))


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_matches_oracle(entry, catalog):
    cat = catalog
    ref_clip = cat["clip_ref"]
    ranked, dedup = oracle_align(cat["rows"], ref_clip)
    ref_sid, ref_delta, _votes = ranked[0]
    ref_count = dedup[ref_sid]
    assert ref_sid == cat["sid1"]

    if entry == "ingest_device_batch":
        ix = cat["ix"]
        mine = ix.song_id == cat["sid1"]
        got = set(zip((h.lower() for h, m in zip(cat["hexes"], mine) if m),
                      ix.offset[mine].astype(int).tolist()))
        jac = _jaccard(got, set(oracle_fingerprint(cat["songs"][1])))
        assert jac > 0.98, jac
        return
    if entry == "fingerprint_probe_on_device":
        jac = _jaccard(_device_query_pairs(cat), ref_clip)
        assert jac > 0.98, jac
        return
    if entry == "recognize_clip":
        top = cat["sia"].recognize_clip(cat["clip"])["results"][0]
        sid, delta = top["song_id"], top["offset"]
        count, n_pairs = (top["hashes_matched_in_input"],
                          top["input_total_hashes"])
    else:
        sid, delta, count, n_pairs = _spanned_raw(cat)
    assert (sid, delta) == (ref_sid, ref_delta)
    assert abs(count - ref_count) <= 0.02 * ref_count, (count, ref_count)
    assert abs(n_pairs - len(ref_clip)) <= 0.02 * len(ref_clip)

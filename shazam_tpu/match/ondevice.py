"""Single-dispatch recognition: samples -> ranked songs in ONE device call.

The two-dispatch path (fingerprint, host dedup via numpy, match) costs two
host<->device round trips plus host set arithmetic — fine for batch
benches, but serving latency is dominated by those hops. This program
keeps everything on device:

1. fingerprint (``ops.fingerprint.fingerprint_batch``),
2. query dedup on device: lexicographic multi-key sort of the hash lanes
   (invalid lanes forced to the max key), first-occurrence masks for
   unique (hash, offset) pairs and unique hashes — the reference's
   Python-set + mapper construction (``recognizer.py:237-242,378-382``)
   as sort ops,
3. match + vote + rank against the HBM index.

Returns the RawMatch plus the unique pair count (the reference's
``len(hashes)`` for the confidence ratios).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.fingerprint import fingerprint_batch
from .lookup import (match_local, match_query_pruned, match_query_sparse,
                     query_total, rank_votes, RawMatch, check_vote_key,
                     _expand_any_spans, _pruned_vote_rank,
                     _sparse_vote_rank, _rank_by_name)


def _fingerprint_dedup(samples, n_valid, *, fs, wsize, hop, amp_min,
                       radius, fan_value, min_dt, max_dt, peak_capacity,
                       query_capacity):
    """Fingerprint + on-device query dedup (steps 1-2 of the
    single-dispatch program; shared by the flat and spanned matchers).

    Returns (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs, n_peaks,
    n_hashes_total) — query lanes sorted by (hash, offset) and sliced to
    ``query_capacity``.
    """
    n_frames_max = (samples.shape[1] - wsize) // hop + 1
    if n_frames_max > 1 << 16:
        raise ValueError(
            f"clip spans {n_frames_max} frames > 2^16: the packed "
            "(ex, t1) dedup sort key would alias offsets. Use "
            "recognize_samples for clips longer than ~51 minutes."
        )
    fp = fingerprint_batch(
        samples, n_valid,
        fs=fs, wsize=wsize, hop=hop, amp_min=amp_min, radius=radius,
        fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
    )
    hi = fp.hi[0]
    lo = fp.lo[0]
    ex = fp.ex[0]
    t1 = fp.t1[0]
    valid = fp.valid[0]
    n_hashes_total = jnp.sum(valid.astype(jnp.int32))

    # compact valid pairs to query_capacity lanes first (order-preserving
    # top_k over flat indices) — the dedup sort below is the latency
    # hot-spot and its cost is linear in lanes
    n_lanes = hi.shape[0]
    cap = min(query_capacity, n_lanes)
    score = jnp.where(
        valid, n_lanes - jnp.arange(n_lanes, dtype=jnp.int32), 0
    )
    vals, idx = jax.lax.top_k(score, cap)
    ok = vals > 0
    safe = jnp.where(ok, idx, 0)
    hi = jnp.take(hi, safe)
    lo = jnp.take(lo, safe)
    ex = jnp.take(ex, safe)
    t1 = jnp.take(t1, safe)
    valid = ok

    # device-side set() + mapper: sort by (hash, offset), invalid last.
    # ex (16 bits) and t1 pack into ONE uint32 sort key: a 3-key sort
    # measures ~25% faster than the 4-key one. 2^16 frames is ~51 min at
    # hop 2048 / 44.1 kHz — the static guard above keeps the packing
    # exact (longer clips belong on the two-dispatch path anyway)
    sort_hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF))
    ex_t1 = (ex << jnp.uint32(16)) | (t1 & jnp.uint32(0xFFFF))
    sort_hi, lo, ex_t1, valid = jax.lax.sort(
        (sort_hi, lo, ex_t1, valid), num_keys=3
    )
    ex = ex_t1 >> jnp.uint32(16)
    t1 = ex_t1 & jnp.uint32(0xFFFF)
    same_hash = jnp.concatenate([
        jnp.zeros(1, bool),
        (sort_hi[1:] == sort_hi[:-1]) & (lo[1:] == lo[:-1])
        & (ex[1:] == ex[:-1]),
    ])
    same_pair = same_hash & jnp.concatenate(
        [jnp.zeros(1, bool), t1[1:] == t1[:-1]]
    )
    q_valid = valid & ~same_pair          # unique (hash, offset) pairs
    q_first = q_valid & ~same_hash        # first pair of each unique hash
    n_pairs = jnp.sum(q_valid.astype(jnp.int32))
    return (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs,
            fp.n_peaks[0], n_hashes_total)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "fan_value",
                     "min_dt", "max_dt", "peak_capacity",
                     "query_capacity", "u_steps"),
)
def fingerprint_probe_on_device(
    samples: jnp.ndarray,          # (1, padded_len) float32
    n_valid: jnp.ndarray,          # (1,) int32
    index_arrays,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 4096,
    query_capacity: int = 4096,
    head=None,
    uview=None,
    u_steps: int = 0,
):
    """Fingerprint + EXACT-total bounds probe, pairs kept on device.

    The big-index solo path (api.recognize_clip past
    config.bounds_probe_min_rows): at production scale every clip
    overflows the fast tier, so the single-dispatch fast-tier match is a
    wasted dispatch — this program fingerprints, dedups, and probes the
    exact matched-row total (lookup.query_total) in ONE dispatch; the
    caller reads the scalar total and dispatches the match ONCE at the
    fitting tier, feeding these device-resident query arrays straight
    into match_query_sparse (no host round trip for the pairs).

    Returns (q_pairs_tuple, n_pairs, n_peaks, n_hashes_total, total,
    lb, ub) where q_pairs_tuple = (sort_hi, lo, ex, t1, q_valid,
    q_first) and (lb, ub) are the per-lane search bounds — the caller
    passes them back as the matcher's ``bounds`` so the fitted dispatch
    skips the descent entirely.
    """
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs, n_peaks,
     n_hashes_total) = _fingerprint_dedup(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
        query_capacity=query_capacity,
    )
    total, lb, ub = query_total(index_arrays, sort_hi, lo, ex, q_valid,
                                head=head, uview=uview, u_steps=u_steps,
                                with_bounds=True)
    return ((sort_hi, lo, ex, t1, q_valid, q_first), n_pairs, n_peaks,
            n_hashes_total, total, lb, ub)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "fan_value",
                     "min_dt", "max_dt", "peak_capacity", "n_songs",
                     "delta_min", "delta_range", "match_capacity", "topn",
                     "offset_stride", "query_capacity",
                     "u_steps", "rank_candidates", "sparse_threshold",
                     "vote_rank", "expand_block", "expand_runs"),
)
def recognize_on_device(
    samples: jnp.ndarray,          # (1, padded_len) float32
    n_valid: jnp.ndarray,          # (1,) int32
    index_arrays,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 4096,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 16384,
    topn: int = 2,
    offset_stride: int = 0,
    query_capacity: int = 4096,
    head=None,
    uview=None,
    u_steps: int = 0,
    rank_candidates: int = 0,
    sparse_threshold: int = 16_000_000,
    vote_rank: str = "pruned",
    expand_block: int = 0,
    expand_runs: int = 0,
):
    """One jitted program: mono clip -> (RawMatch, n_pairs, n_peaks, n_hash).

    Binary-search cost is linear in query lanes, so after the dedup sort
    the query is sliced to `query_capacity` lanes (valid lanes sort to the
    front; a 5-15 s clip yields 1-8K hashes). The caller checks the
    returned total hash count against query_capacity and falls back to
    the two-dispatch path on overflow.
    """
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs, n_peaks,
     n_hashes_total) = _fingerprint_dedup(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
        query_capacity=query_capacity,
    )

    if n_songs * delta_range > sparse_threshold:
        # big catalogs: vote_rank selects between the element-identical
        # sparse ranks — "pruned" (candidate-pruned with in-program sort
        # fallback, when rank_candidates > 0), "sort", or the
        # scatter-free "scan" (see lookup._scan_vote_rank)
        if vote_rank == "pruned" and rank_candidates > 0:
            raw, _ok = match_query_pruned(
                index_arrays, sort_hi, lo, ex, t1, q_valid, q_first,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=match_capacity,
                topn=topn, offset_stride=offset_stride, head=head,
                uview=uview, u_steps=u_steps,
                n_candidates=rank_candidates,
                expand_block=expand_block, expand_runs=expand_runs,
            )
        else:
            raw = match_query_sparse(
                index_arrays, sort_hi, lo, ex, t1, q_valid, q_first,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=match_capacity,
                topn=topn, offset_stride=offset_stride, head=head,
                uview=uview, u_steps=u_steps,
                vote_rank=vote_rank if vote_rank != "pruned" else "sort",
                expand_block=expand_block, expand_runs=expand_runs,
            )
    else:
        hist, rows_hist, total, n_dropped = match_local(
            index_arrays, sort_hi, lo, ex, t1, q_valid, q_first,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity, offset_stride=offset_stride,
            head=head, uview=uview, u_steps=u_steps,
        )
        raw = rank_votes(hist, rows_hist, total, delta_min=delta_min,
                         topn=topn, n_dropped=n_dropped)
    return raw, n_pairs, n_peaks, n_hashes_total


@functools.partial(
    jax.jit,
    static_argnames=("fs", "wsize", "hop", "amp_min", "radius", "fan_value",
                     "min_dt", "max_dt", "peak_capacity", "n_songs",
                     "delta_min", "delta_range", "match_capacity", "topn",
                     "offset_stride", "query_capacity",
                     "rank_candidates", "u_steps", "vote_rank",
                     "expand_block", "expand_runs"),
)
def recognize_on_device_spanned(
    samples: jnp.ndarray,          # (1, padded_len) float32
    n_valid: jnp.ndarray,          # (1,) int32
    span_arrays,                   # tuple of per-span column tuples
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 4096,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 16384,
    topn: int = 2,
    offset_stride: int = 0,
    query_capacity: int = 4096,
    heads=None,
    rank_candidates: int = 0,
    uviews=None,
    u_steps: int = 0,
    vote_rank: str = "pruned",
    expand_block: int = 0,
    expand_runs: int = 0,
):
    """``recognize_on_device`` against a spanned index (SpannedDeviceStore).

    One jitted program: clip -> (RawMatch, span_max, n_pairs, n_peaks,
    n_hashes).  Every span is searched with its own bucket-CDF head and
    the vote streams are counted together (see
    ``lookup.match_query_sparse_spanned``); ``span_max`` is the per-span
    overflow signal the caller checks against ``match_capacity``.
    """
    # this path calls _sparse_vote_rank directly, so the wrapped check
    # never runs — apply the single-sourced guard here
    check_vote_key(n_songs, delta_range)
    (sort_hi, lo, ex, t1, q_valid, q_first, n_pairs, n_peaks,
     n_hashes_total) = _fingerprint_dedup(
        samples, n_valid, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
        query_capacity=query_capacity,
    )
    sid, delta, first, valid, total, span_max, n_dropped = \
        _expand_any_spans(
            span_arrays, heads, sort_hi, lo, ex, t1, q_valid, q_first,
            match_capacity=match_capacity, offset_stride=offset_stride,
            uviews=uviews, u_steps=u_steps, expand_block=expand_block,
            expand_runs=expand_runs,
        )
    if vote_rank == "pruned" and rank_candidates > 0:
        raw_p, ok = _pruned_vote_rank(
            sid, delta, first, valid, total, n_dropped,
            n_songs=n_songs, delta_min=delta_min,
            delta_range=delta_range, topn=topn,
            n_candidates=rank_candidates,
        )
        raw = jax.lax.cond(
            ok,
            lambda: raw_p,
            lambda: _sparse_vote_rank(
                sid, delta, first, valid, total, n_dropped,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, topn=topn),
        )
    else:
        rank = _rank_by_name(vote_rank if vote_rank != "pruned"
                             else "sort")
        blocked = (expand_block
                   and not isinstance(span_arrays[0], (tuple, list)))
        raw = rank(
            sid, delta, first, valid, total, n_dropped,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            topn=topn, prefix=match_capacity if blocked else 0,
        )
    return raw, span_max, n_pairs, n_peaks, n_hashes_total
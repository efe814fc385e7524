"""Query matching: batched index lookup + offset-delta histogram voting.

Replaces the reference's L2/L3 stack — batched ``WHERE hash IN``
round trips (``recognizer.py:222-271``), per-row vote expansion and the
groupby vote/rank of ``align_matches`` (``recognizer.py:289-338``) — with
one jitted device program:

1. lane-parallel binary search gives each query (hash, offset) pair its
   bucket [lb, ub) in the sorted index;
2. the matched rows are expanded to a fixed-capacity vote list — slot v
   maps back to its pair by a searchsorted over the bucket-length prefix
   sums (all vector ops, no data-dependent loops);
3. votes scatter-add into a dense (n_songs, delta_range) histogram;
   per-song best delta = row argmax, ranking = top_k. The reference's tie
   semantics fall out for free: argmax takes the smallest delta, top_k
   the smallest song id.

Semantics preserved exactly (verified against the oracle in
tests/test_match.py):
- every matched DB row votes once per query offset of its hash
  (the ``mapper[hsh]`` loop, ``recognizer.py:266-269``);
- ``dedup_hashes`` counts each row once per *distinct* query hash
  (``recognizer.py:259-264``) — pairs are flagged as first-occurrence of
  their hash and only those pairs' rows are counted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..index.search import lexi_bounds, unique_bounds


def check_vote_key(n_songs: int, delta_range: int) -> None:
    """Reject configs whose flat (song, delta) vote key overflows int32 —
    votes would silently land on wrong songs. THE one guard every dense
    matcher calls (lookup, ondevice, apriori)."""
    if n_songs * delta_range >= 1 << 31:
        raise ValueError(
            f"n_songs * delta_range = {n_songs * delta_range} overflows the "
            "int32 vote key (>= 2^31): votes would be attributed to wrong "
            "songs silently. Use the by-song sharded regime "
            "(parallel.serving.ShardedCatalog) for catalogs this large."
        )


class RawMatch(NamedTuple):
    """Device-side match result (fixed shapes).

    ``n_dropped``/``runner_votes`` power the PROVABLY-EXACT early accept
    (api._match_prepared): the expansion includes whole runs shortest-
    first within match_capacity, so each of the ``n_dropped`` excluded
    runs (one run = one query hash's contiguous row bucket, all rows
    DISTINCT (song, offset)) can add at most ONE vote to any
    (song, delta) bin.  Hence when
    ``top_votes[0] - runner_votes > n_dropped`` the top-1 song AND its
    best delta are the same as a full (uncapped) expansion would
    report, and the escalated re-dispatch is skipped.  ``runner_votes``
    is max(second-ranked song's votes, the top song's second-best
    delta-bin votes) — covering both ways a dropped vote could flip the
    answer."""

    top_songs: jnp.ndarray     # int32 (topn,)
    top_deltas: jnp.ndarray    # int32 (topn,) best db_offset - q_offset per song
    top_votes: jnp.ndarray     # int32 (topn,) aligned vote count
    row_counts: jnp.ndarray    # int32 (topn,) dedup_hashes per top song
    total_rows: jnp.ndarray    # int32 scalar — true expanded match count
    n_ranked: jnp.ndarray      # int32 scalar — songs with >= 1 vote
    n_dropped: jnp.ndarray     # int32 scalar — runs excluded by the budget
    runner_votes: jnp.ndarray  # int32 scalar — strongest challenger count


def _expand_blocked(index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, *,
                    match_capacity: int, offset_stride: int,
                    block_size: int, head=None, uview=None,
                    u_steps: int = 0, max_runs: int = 0, bounds=None):
    """Block-gather expansion: ``_expand``'s contract, sequential reads.

    The scalar expansion issues ``match_capacity`` independent payload
    gathers of random-access device memory, the wall of every escalated
    tier. Matched rows are CONTIGUOUS runs, so this reads them as
    aligned ``block_size``-row rows of the payload's (N/B, B) reshape:
    each gathered element is one sequential read, so the expansion
    moves the same bytes in cap/B transfers.

    Semantics: whole runs, shortest-first (in blocks), ``total`` exact,
    ``n_dropped`` = runs the budget excluded — the same invariants the
    early-accept proof needs. The static budget is ``match_capacity //
    B + 2 * R`` blocks (alignment can waste up to 2 partial blocks per
    nonempty run), where ``R = min(n_lanes, max_runs or n_lanes)``.
    ``max_runs`` matters because the rank downstream pays per STREAM
    element and query packs pad lanes to a pow2 bucket: at 4096 padded lanes / B=128 the default budget adds
    1.05M stream elements while real 15 s clips hold < 1024 nonempty
    runs.  Runs past the shortest-first ``max_runs`` budget are DROPPED
    and counted in ``n_dropped`` (never silent — the early-accept
    certificate and the caller's escalation/scalar-fallback policy see
    them), so "row total <= match_capacity AND nonempty runs <= R =>
    nothing dropped" holds; under clamp the excluded SET can differ
    from the scalar path's (both are valid whole-run budgets).

    Returns (sid, delta, p, valid, total, n_dropped) with arrays of
    length ``cap_blocks * B`` — callers are length-agnostic. Requires
    the packed payload layout and ``N % block_size == 0`` (device
    uploads sentinel-pad to block multiples; see pack_padded_cols).
    """
    B = block_size
    payload = index_arrays[3]
    if offset_stride == 0:
        raise ValueError("blocked expansion needs the packed payload "
                         "layout (offset_stride > 0)")
    if payload.shape[0] % B:
        raise ValueError(
            f"payload rows {payload.shape[0]} not a multiple of the "
            f"block size {B} — pad the device columns (pack_padded_cols "
            "rounds capacity up)")
    if bounds is not None:
        lb, ub = bounds
    elif uview is not None:
        lb, ub = unique_bounds(uview, q_hi, q_lo, q_ex, q_valid,
                               steps=u_steps)
    else:
        k_hi, k_lo, k_ex = index_arrays[:3]
        lb, ub = lexi_bounds(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex,
                             head=head, q_valid=q_valid)
    lens = jnp.where(q_valid, ub - lb, 0)
    return _blocked_expand_core(
        payload, lb, ub, lens, q_t, block_size=B,
        match_capacity=match_capacity, offset_stride=offset_stride,
        max_runs=max_runs)


def _blocked_expand_core(payload, lb, ub, lens, q_t, *, block_size: int,
                         match_capacity: int, offset_stride: int,
                         max_runs: int = 0, pair_mod: int = 0):
    """Shared blocked-gather core over FLAT run bounds.

    ``lb``/``ub``/``lens`` are flat row bounds per run (one run per
    query lane for the single-index path; span-major ``s * n_pairs +
    pair`` for the stacked spanned path, where ``pair_mod = n_pairs``
    maps a run back to its owning query pair). ``payload`` is the flat
    packed payload column; runs never straddle a block boundary across
    spans because span_rows (and the device capacity) are multiples of
    the block size — validated by the callers.

    Returns (sid, delta, p, valid, total, n_dropped) exactly like
    ``_expand``, with ``p`` the owning query-pair index per slot.
    """
    B = block_size
    total = jnp.sum(lens)
    b0 = lb // B
    b1 = (ub + B - 1) // B
    nblk = jnp.where(lens > 0, b1 - b0, 0)

    order = jnp.argsort(nblk)          # shortest-first, in block units
    nblk_s = jnp.take(nblk, order)
    b0_s = jnp.take(b0, order)
    n_runs = lens.shape[0]
    runs_budget = min(n_runs, max_runs) if max_runs else n_runs
    cap_blocks = match_capacity // B + 2 * runs_budget
    cum = jnp.cumsum(nblk_s)
    nonempty = nblk_s > 0
    # ROW-accurate inclusion alongside the block budget: included live
    # rows never exceed match_capacity, so after the rank's key sort
    # every live key sits in the first match_capacity slots — the ranks
    # run on that static prefix instead of the padded block stream
    # (rank passes cost per STREAM element; see _scan_vote_rank).
    # "total <= capacity (and runs <= budget) => nothing dropped" still
    # holds: both cumulative budgets admit every run then.
    cum_rows = jnp.cumsum(jnp.take(lens, order))
    included = (cum <= cap_blocks) & (cum_rows <= match_capacity)
    if runs_budget < n_runs:
        # shortest-first rank among nonempty runs; runs past the budget
        # are dropped exactly like block-budget overflows
        run_rank = jnp.cumsum(nonempty.astype(jnp.int32))
        included = included & (run_rank <= runs_budget)
    n_dropped = jnp.sum((nonempty & ~included).astype(jnp.int32))
    nblk_inc = jnp.where(included, nblk_s, 0)
    cum_inc = jnp.cumsum(nblk_inc)
    total_blocks = cum_inc[-1]

    v = jnp.arange(cap_blocks, dtype=jnp.int32)
    marks = jnp.zeros(cap_blocks, jnp.int32).at[cum_inc].add(
        1, mode="drop")
    pb = jnp.cumsum(marks)
    pb = jnp.minimum(pb, n_runs - 1)
    prev = jnp.where(pb > 0, jnp.take(cum_inc, pb - 1), 0)
    blk = jnp.take(b0_s, pb) + (v - prev)
    blk_valid = v < total_blocks
    run = jnp.take(order, pb)          # owning run per block
    pair = run % pair_mod if pair_mod else run

    safe_blk = jnp.where(blk_valid, blk, 0)
    rows = jnp.take(payload.reshape(-1, B), safe_blk, axis=0)
    g = safe_blk[:, None] * B + jnp.arange(B, dtype=jnp.int32)[None, :]
    lbr = jnp.take(lb, run)[:, None]
    ubr = jnp.take(ub, run)[:, None]
    valid = blk_valid[:, None] & (g >= lbr) & (g < ubr)

    sid = (rows // jnp.uint32(offset_stride)).astype(jnp.int32)
    doff = (rows % jnp.uint32(offset_stride)).astype(jnp.int32)
    delta = doff - jnp.take(q_t, pair).astype(jnp.int32)[:, None]
    p = jnp.broadcast_to(pair[:, None], (cap_blocks, B))
    # invalid slots must decode in-range like the scalar path's
    # safe_row=0 (rank scatters mask by `valid`, but sid feeds index
    # arithmetic before masking)
    sid = jnp.where(valid, sid, 0)
    delta = jnp.where(valid, delta, 0)
    return (sid.reshape(-1), delta.reshape(-1), p.reshape(-1),
            valid.reshape(-1), total, n_dropped)


@functools.partial(jax.jit, static_argnames=("u_steps", "with_bounds"))
def query_total(index_arrays, q_hi, q_lo, q_ex, q_valid, *,
                head=None, uview=None, u_steps: int = 0,
                with_bounds: bool = False):
    """EXACT total matched-row count: one search pass, no expansion.

    The bounds probe behind the api's bounds-first escalation policy
    (config.bounds_probe_min_rows): at production scale most real
    queries overflow the fast tier, so a full fast-tier program is
    mostly wasted — this probe (a search, no expansion) reads the exact
    total and the caller dispatches straight to the fitting tier.

    ``with_bounds=True`` also returns the per-lane (lb, ub) so the
    fitted dispatch can REUSE the search instead of re-descending (the
    descent is a fixed-round loop of latency-bound gathers): the caller
    keeps them on device
    and passes them back as the matcher's ``bounds`` argument.
    """
    if uview is not None:
        lb, ub = unique_bounds(uview, q_hi, q_lo, q_ex, q_valid,
                               steps=u_steps)
    else:
        k_hi, k_lo, k_ex = index_arrays[:3]
        lb, ub = lexi_bounds(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex,
                             head=head, q_valid=q_valid)
    total = jnp.sum(jnp.where(q_valid, ub - lb, 0))
    if with_bounds:
        return total, lb, ub
    return total


def _expand(index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, *,
            match_capacity: int, offset_stride: int, head=None,
            uview=None, u_steps: int = 0, expand_block: int = 0,
            expand_runs: int = 0, bounds=None):
    """Search + fixed-capacity row expansion (shared by the matchers).

    Returns (sid, delta, p, valid, total, n_dropped): per expanded vote
    slot, the song id, offset delta, owning query-pair index, validity,
    the TRUE total match count (exact even when expansion clamps), and
    the number of runs the capacity budget excluded.
    ``head`` is an optional ``search.build_head`` bucket CDF giving
    exact per-lane search windows (distribution-proof fast bounds);
    ``uview``/``u_steps`` (a ``search.UniqueView`` + its static round
    count) replace the two-descent search entirely with one fixed-round
    descent over the unique-key table — preferred when available.

    Capacity policy: WHOLE runs, shortest first.  When the total match
    count exceeds ``match_capacity`` the old prefix clamp kept the
    first capacity rows in lane order — all the evidence from the first
    few query hashes, none from the rest.  Instead the runs are sorted
    by length and included whole until the budget is spent: a dropped
    run can contribute at most one vote to any (song, delta) bin (its
    rows are distinct (song, offset) under one query offset), so
    ``n_dropped`` is an exact upper bound on how many votes any bin is
    missing — the foundation of the provably-exact early accept (see
    ``RawMatch``).  The longest (= least informative, most expensive)
    runs are the ones excluded.  When nothing clamps the vote set is
    identical to before (order permuted; every consumer is
    order-independent).
    """
    if expand_block:
        return _expand_blocked(
            index_arrays, q_hi, q_lo, q_ex, q_t, q_valid,
            match_capacity=match_capacity, offset_stride=offset_stride,
            block_size=expand_block, head=head, uview=uview,
            u_steps=u_steps, max_runs=expand_runs, bounds=bounds)
    if bounds is not None:
        lb, ub = bounds
    elif uview is not None:
        lb, ub = unique_bounds(uview, q_hi, q_lo, q_ex, q_valid,
                               steps=u_steps)
    else:
        k_hi, k_lo, k_ex = index_arrays[:3]
        lb, ub = lexi_bounds(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex,
                             head=head, q_valid=q_valid)
    lens = jnp.where(q_valid, ub - lb, 0)
    total = jnp.sum(lens) if lens.shape[0] else jnp.int32(0)

    # shortest-first run budget (stable sort: equal lengths keep lane
    # order — deterministic programs)
    order = jnp.argsort(lens)
    lens_s = jnp.take(lens, order)
    lb_s = jnp.take(lb, order)
    cum = jnp.cumsum(lens_s)
    included = cum <= match_capacity
    n_dropped = jnp.sum(((lens_s > 0) & ~included).astype(jnp.int32))
    lens_inc = jnp.where(included, lens_s, 0)
    cum_inc = jnp.cumsum(lens_inc)
    total_inc = cum_inc[-1] if lens.shape[0] else jnp.int32(0)

    # expand: slot v -> owning (sorted-space) run p_s. p_s[v] =
    # #{i: cum_inc[i] <= v}, computed as a scatter of ones at the bucket
    # boundaries + one prefix sum — a searchsorted here costs
    # match_capacity * log2(n_pairs) dependent random gathers, ~3x
    # the search descent's
    v = jnp.arange(match_capacity, dtype=jnp.int32)
    marks = jnp.zeros(match_capacity, jnp.int32).at[cum_inc].add(
        1, mode="drop")
    p = jnp.cumsum(marks)
    p = jnp.minimum(p, lens.shape[0] - 1)
    prev = jnp.where(p > 0, jnp.take(cum_inc, p - 1), 0)
    row = jnp.take(lb_s, p) + (v - prev)
    valid = v < total_inc
    p = jnp.take(order, p)   # back to the caller's lane indexing

    safe_row = jnp.where(valid, row, 0)
    if offset_stride:
        packed = jnp.take(index_arrays[3], safe_row)
        sid = (packed // jnp.uint32(offset_stride)).astype(jnp.int32)
        doff = (packed % jnp.uint32(offset_stride)).astype(jnp.int32)
    else:
        sid = jnp.take(index_arrays[3], safe_row).astype(jnp.int32)
        doff = jnp.take(index_arrays[4], safe_row).astype(jnp.int32)
    qoff = jnp.take(q_t, p).astype(jnp.int32)
    delta = doff - qoff
    return sid, delta, p, valid, total, n_dropped


def match_local(
    index_arrays,
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int,
    offset_stride: int = 0,
    head=None,
    uview=None,
    u_steps: int = 0,
    expand_block: int = 0,
):
    """Core match against one (shard of the) sorted index.

    index_arrays is (key_hi, key_lo, key_ex, packed_payload) with
    ``offset_stride`` > 0 (payload = song_id * stride + offset — one HBM
    gather per matched row), or the 5-tuple (... song_id, offset) with
    ``offset_stride`` == 0 for catalogs too large to pack.

    Returns (hist, rows_hist, total, n_dropped): the dense (n_songs,
    delta_range) vote histogram, per-song dedup row counts, the true
    expanded match count, and the count of budget-excluded runs. Pure
    function of the local index slice — the sharded path psums these
    across devices before ranking (n_dropped sums correctly: each
    excluded run anywhere adds <= 1 vote to any global bin).
    """
    check_vote_key(n_songs, delta_range)
    sid, delta, p, valid, total, n_dropped = _expand(
        index_arrays, q_hi, q_lo, q_ex, q_t, q_valid,
        match_capacity=match_capacity, offset_stride=offset_stride,
        head=head, uview=uview, u_steps=u_steps,
        expand_block=expand_block,
    )

    # dense (n_songs, delta_range) vote histogram; deltas outside the
    # representable window are dropped (callers size the window so real
    # deltas always fit: delta_min = -max query frame, range covers the
    # longest catalog song)
    dbin = delta - delta_min
    in_range = (dbin >= 0) & (dbin < delta_range)
    flat_key = jnp.where(in_range, sid * delta_range + dbin, 0)
    hist = jnp.zeros(n_songs * delta_range, jnp.int32)
    hist = hist.at[flat_key].add((valid & in_range).astype(jnp.int32), mode="drop")
    hist = hist.reshape(n_songs, delta_range)

    # dedup row counts: one per row per distinct query hash (per-block
    # gather when the stream is blocked — see _take_first)
    first = _take_first(q_first, p, expand_block)
    rows_hist = jnp.zeros(n_songs, jnp.int32)
    rows_hist = rows_hist.at[sid].add(
        (valid & first).astype(jnp.int32), mode="drop"
    )
    return hist, rows_hist, total, n_dropped


def rank_votes(hist, rows_hist, total, *, delta_min: int, topn: int,
               n_dropped=None) -> RawMatch:
    """Per-song best delta + top-N ranking with the reference tie rules.

    ``n_dropped`` (int32 scalar) flows through from the expansion;
    ``runner_votes`` — the strongest challenger to (top-1 song, its best
    delta): max(second-ranked song's votes, top-1's second-best bin) —
    is computed here so every dense matcher gets the early-accept
    decision inputs (see ``RawMatch``).
    """
    votes_per_song = jnp.max(hist, axis=1)
    best_bin = jnp.argmax(hist, axis=1)  # first max => smallest delta

    k = min(topn, votes_per_song.shape[0])  # catalogs smaller than topn
    top_votes, top_songs = jax.lax.top_k(votes_per_song, k)
    if k < topn:
        top_votes = jnp.pad(top_votes, (0, topn - k))
        top_songs = jnp.pad(top_songs, (0, topn - k))
    top_deltas = jnp.take(best_bin, top_songs).astype(jnp.int32) + delta_min
    row_counts = jnp.take(rows_hist, top_songs)
    n_ranked = jnp.sum((votes_per_song > 0).astype(jnp.int32))

    # strongest challenger: 2nd-ranked song (computed at k=2 regardless
    # of topn) and the winner's own 2nd-best delta bin (a tie within the
    # song makes the reported delta fragile too)
    k2 = min(2, votes_per_song.shape[0])
    tv2 = jax.lax.top_k(votes_per_song, k2)[0]
    second_song = tv2[1] if k2 == 2 else jnp.int32(0)
    top_row = jax.lax.dynamic_index_in_dim(hist, top_songs[0], 0,
                                           keepdims=False)
    bins = jnp.arange(top_row.shape[0], dtype=jnp.int32)
    second_bin = jnp.max(jnp.where(bins == best_bin[top_songs[0]],
                                   jnp.int32(-1), top_row))
    runner = jnp.maximum(second_song, second_bin).astype(jnp.int32)
    if n_dropped is None:
        n_dropped = jnp.int32(0)

    return RawMatch(
        top_songs.astype(jnp.int32),
        top_deltas,
        top_votes,
        row_counts,
        total,
        n_ranked,
        jnp.asarray(n_dropped, jnp.int32),
        runner,
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "u_steps"),
)
def match_query(
    index_arrays,
    q_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_ex: jnp.ndarray,
    q_t: jnp.ndarray,
    q_valid: jnp.ndarray,
    q_first: jnp.ndarray,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    head=None,
    uview=None,
    u_steps: int = 0,
) -> RawMatch:
    """Match padded query pairs against the sorted index (single device).

    :param index_arrays: sorted key arrays + payload — see ``match_local``
        (use ``FingerprintIndex.device_arrays()`` + ``.offset_stride``).
    :param q_*: query (hash, offset) pairs padded to a static length;
        `q_valid` masks real pairs; `q_first` marks the first pair of each
        distinct hash (for dedup row counting).
    :param delta_min: smallest representable delta (-max query offset).
    """
    hist, rows_hist, total, n_dropped = match_local(
        index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        match_capacity=match_capacity, offset_stride=offset_stride,
        head=head, uview=uview, u_steps=u_steps,
    )
    return rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                      n_dropped=n_dropped)


def _take_first(q_first, p, expand_block: int):
    """``q_first[p]`` for the expanded stream — without the full-stream
    gather when the stream is BLOCKED.

    A flat ``jnp.take(q_first, p)`` over the blocked stream is one
    random gather per stream element. Blocked expansion's
    ``p`` is CONSTANT within each block (``_blocked_expand_core``
    broadcasts the owning pair across the block's lanes), so gathering
    once per block and broadcasting is element-identical at 1/B the
    gather cost."""
    if expand_block and p.shape[0] % expand_block == 0:
        pair_blk = p.reshape(-1, expand_block)[:, 0]
        return jnp.broadcast_to(
            jnp.take(q_first, pair_blk)[:, None],
            (pair_blk.shape[0], expand_block)).reshape(-1)
    return jnp.take(q_first, p)


def _rank_by_name(vote_rank: str):
    """Static dispatch between the element-identical sparse ranks.

    ``"sort"`` — ``_sparse_vote_rank`` (sort + segment scatters);
    ``"scan"`` — ``_scan_vote_rank`` (sort + cumulative scans, no
    scatters — ~10x less per-element HBM RMW at escalated capacities).
    """
    if vote_rank == "sort":
        return _sparse_vote_rank
    if vote_rank == "scan":
        return _scan_vote_rank
    raise ValueError(f"unknown vote_rank {vote_rank!r} "
                     "(expected 'sort' or 'scan')")


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "u_steps", "expand_block",
                     "expand_runs", "vote_rank", "with_bounds"),
)
def match_query_sparse(
    index_arrays,
    q_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_ex: jnp.ndarray,
    q_t: jnp.ndarray,
    q_valid: jnp.ndarray,
    q_first: jnp.ndarray,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    head=None,
    uview=None,
    u_steps: int = 0,
    expand_block: int = 0,
    expand_runs: int = 0,
    vote_rank: str = "sort",
    bounds=None,
    with_bounds: bool = False,
) -> RawMatch:
    """``match_query`` without the dense histogram — EXACT, for big catalogs.

    The dense (n_songs, delta_range) vote histogram costs ~3 full passes
    over n_songs * delta_range * 4 bytes per query (~1.5 GB at 12K
    songs).  A query only produces <= match_capacity votes, so the
    histogram is inherently sparse: sort the packed (song, delta) vote
    keys, run-length count them with segment ops, and reduce per song
    with small scatter-max/min passes — O(match_capacity) work plus two
    O(n_songs) scalar arrays, identical results (same tie rules: the
    scatter-min best-delta mirrors argmax-takes-first, top_k ties keep
    the smallest song id).

    ``with_bounds=True`` additionally returns the per-lane search
    (lb, ub) — computed ONCE and shared with the expansion, so the
    program is the same work. The decided-first escalation policy
    (api._match_prepared, config.escalation_policy) keeps them
    device-resident and, when the clamped dispatch is NOT provably
    decided, re-dispatches at the fitting tier with ``bounds=(lb, ub)``
    — the exact total is already known (``total_rows`` is exact even
    when clamped) and the descent never runs twice.
    """
    check_vote_key(n_songs, delta_range)
    if with_bounds and bounds is None:
        if uview is not None:
            bounds = unique_bounds(uview, q_hi, q_lo, q_ex, q_valid,
                                   steps=u_steps)
        else:
            k_hi, k_lo, k_ex = index_arrays[:3]
            bounds = lexi_bounds(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex,
                                 head=head, q_valid=q_valid)
    sid, delta, p, valid, total, n_dropped = _expand(
        index_arrays, q_hi, q_lo, q_ex, q_t, q_valid,
        match_capacity=match_capacity, offset_stride=offset_stride,
        head=head, uview=uview, u_steps=u_steps,
        expand_block=expand_block, expand_runs=expand_runs,
        bounds=bounds,
    )
    first = _take_first(q_first, p, expand_block)
    raw = _rank_by_name(vote_rank)(
        sid, delta, first, valid, total, n_dropped,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        topn=topn, prefix=match_capacity if expand_block else 0,
    )
    if with_bounds:
        return raw, bounds[0], bounds[1]
    return raw


def _sparse_vote_rank(sid, delta, first, valid, total, n_dropped=None, *,
                      n_songs: int, delta_min: int, delta_range: int,
                      topn: int, prefix: int = 0) -> RawMatch:
    """Sort + run-length vote count + rank over flat expanded vote slots.

    Shared by ``match_query_sparse`` (one expansion) and the spanned
    matcher (concatenated expansions from several sorted spans — vote
    keys from different spans for the same (song, delta) coalesce in the
    sort exactly as if they came from one index; per-span ``n_dropped``
    sums: a run excluded in any span adds <= 1 vote to any global bin).
    """
    cap = sid.shape[0]
    dbin = delta - delta_min
    in_range = (dbin >= 0) & (dbin < delta_range)
    vote_ok = valid & in_range

    SENT = jnp.int32(0x7FFFFFFF)
    key = jnp.where(vote_ok, sid * delta_range + dbin, SENT)
    ks = jax.lax.sort(key)
    if prefix and prefix < cap:
        # see _scan_vote_rank: blocked row-budgeted streams hold every
        # live key in the first `prefix` sorted slots
        ks = ks[:prefix]
        cap = prefix
    live = ks != SENT
    run_start = live & jnp.concatenate(
        [jnp.ones(1, bool), ks[1:] != ks[:-1]])
    seg_id = jnp.cumsum(run_start.astype(jnp.int32)) - 1  # -1 before 1st
    safe_seg = jnp.where(live, seg_id, cap - 1)
    counts_seg = jnp.zeros(cap, jnp.int32).at[safe_seg].add(
        live.astype(jnp.int32), mode="drop")
    key_seg = jnp.full(cap, SENT, jnp.int32).at[safe_seg].min(
        jnp.where(live, ks, SENT), mode="drop")

    song_seg = jnp.where(key_seg != SENT, key_seg // delta_range, n_songs)
    dbin_seg = jnp.where(key_seg != SENT, key_seg % delta_range, 0)

    votes_per_song = jnp.zeros(n_songs, jnp.int32).at[song_seg].max(
        counts_seg, mode="drop")
    back = jnp.take(votes_per_song, jnp.minimum(song_seg, n_songs - 1))
    is_best = (key_seg != SENT) & (counts_seg == back)
    best_bin = jnp.full(n_songs, 0x7FFFFFFF, jnp.int32).at[song_seg].min(
        jnp.where(is_best, dbin_seg, 0x7FFFFFFF), mode="drop")

    rows_hist = jnp.zeros(n_songs, jnp.int32).at[sid].add(
        (valid & first).astype(jnp.int32), mode="drop")

    k = min(topn, n_songs)
    top_votes, top_songs = jax.lax.top_k(votes_per_song, k)
    if k < topn:
        top_votes = jnp.pad(top_votes, (0, topn - k))
        top_songs = jnp.pad(top_songs, (0, topn - k))
    bb = jnp.take(best_bin, top_songs)
    # zero-vote songs (catalogs smaller than topn): dense argmax gives
    # bin 0 -> delta_min; mirror it
    top_deltas = jnp.where(bb == 0x7FFFFFFF, 0, bb).astype(jnp.int32) \
        + delta_min
    row_counts = jnp.take(rows_hist, top_songs)
    n_ranked = jnp.sum((votes_per_song > 0).astype(jnp.int32))

    # strongest challenger (see rank_votes): 2nd-ranked song + the
    # winner's 2nd-best delta bin, from the same segment arrays
    k2 = min(2, n_songs)
    tv2 = jax.lax.top_k(votes_per_song, k2)[0]
    second_song = tv2[1] if k2 == 2 else jnp.int32(0)
    win = top_songs[0]
    win_best = jnp.take(best_bin, win)
    is_second = (song_seg == win) & (dbin_seg != win_best)
    second_bin = jnp.max(jnp.where(is_second, counts_seg, jnp.int32(0)))
    runner = jnp.maximum(second_song, second_bin).astype(jnp.int32)
    if n_dropped is None:
        n_dropped = jnp.int32(0)

    return RawMatch(
        top_songs.astype(jnp.int32), top_deltas, top_votes,
        row_counts, total, n_ranked,
        jnp.asarray(n_dropped, jnp.int32), runner,
    )


def _scan_vote_rank(sid, delta, first, valid, total, n_dropped=None, *,
                    n_songs: int, delta_min: int, delta_range: int,
                    topn: int, prefix: int = 0) -> RawMatch:
    """Scatter-free vote rank: one single-operand sort + cumulative scans.

    ELEMENT-IDENTICAL to ``_sparse_vote_rank`` (tested), built for the
    escalated capacity tiers where that rank's cost lives: the sparse
    rank issues three to four full-stream scatters (segment counts,
    per-segment key min, per-song max/min), each a serialized
    read-modify-write per element.  This rank touches device memory with
    exactly one int32 sort plus a
    handful of elementwise/cumulative passes:

    1. sort the packed vote keys (``song * delta_range + dbin`` —
       ``check_vote_key`` guarantees int32); invalid slots carry the
       int32-max sentinel and sort to a contiguous tail;
    2. per-run vote counts WITHOUT a scatter: a run's count is the
       distance to the next key boundary — one reverse ``lax.cummin``
       over (boundary ? index : cap) gives every run start its end;
    3. the reference tie rules fall out of sorted order: the FIRST
       global maximum of the per-run counts is the smallest
       (song, dbin) key holding it, i.e. the smallest-song-id winner
       and its smallest best delta — ``jnp.argmax`` IS the rank.  Top-n
       iterates masked argmax (topn is a small static), masking each
       chosen song's runs;
    4. per-top-song dedup row counts / the challenger maximum / the
       ranked-song count are masked reductions over the (unsorted or
       sorted) stream — bandwidth passes, no tables.

    No O(n_songs) or O(table) state is ever allocated, so the rank also
    vmaps cleanly for the batched matcher (no per-clip 64 MB hashed
    tables) and its cost is the sort.
    """
    cap = sid.shape[0]
    dbin = delta - delta_min
    in_range = (dbin >= 0) & (dbin < delta_range)
    # song ids outside [0, n_songs) must be NON-votes: the scatter ranks
    # drop them implicitly (mode="drop" — an n_songs-length table cannot
    # rank them), but here they would form live sorted runs and could be
    # argmax winners / count into n_ranked (caught at prod12288: a
    # 1-based-id stream carried sid == n_songs and n_ranked went +1).
    # Masking BEFORE the key pack also keeps sid * delta_range in int32.
    vote_ok = valid & in_range & (sid >= 0) & (sid < n_songs)

    # pack with delta_range rounded UP to a power of two when the wider
    # key still fits int32: (song, dbin) -> key is order-preserving for
    # ANY range >= delta_range, so every downstream value is identical,
    # and the two full-stream divmods below become shifts/masks (integer
    # division by a non-pow2 constant is a multi-op sequence per
    # element). Falls back to the exact range when pow2 would
    # overflow (check_vote_key already guarantees the exact range fits).
    dr2 = 1 << max(int(delta_range) - 1, 0).bit_length()
    if n_songs * dr2 >= (1 << 31):
        dr2 = delta_range

    SENT = jnp.int32(0x7FFFFFFF)
    key = jnp.where(vote_ok, sid * dr2 + dbin, SENT)
    ks = jax.lax.sort(key)
    if prefix and prefix < cap:
        # blocked streams with the row-accurate budget hold <= prefix
        # live rows, and SENT sorts last — every live key is in [:prefix]
        # and every post-sort pass runs at the prefix length
        ks = ks[:prefix]
        cap = prefix
    live = ks != SENT                      # contiguous prefix
    idx = jnp.arange(cap, dtype=jnp.int32)
    change = jnp.concatenate([jnp.ones(1, bool), ks[1:] != ks[:-1]])

    # next boundary strictly after i: reverse cummin of (change ? idx :
    # cap), shifted left one — run [i, nxt[i]) for every run start i
    cand = jnp.where(change, idx, jnp.int32(cap))
    nxt_incl = jax.lax.cummin(cand[::-1])[::-1]
    nxt = jnp.concatenate([nxt_incl[1:], jnp.full(1, cap, jnp.int32)])
    run_start = change & live
    count = jnp.where(run_start, nxt - idx, 0)
    song = jnp.where(live, ks // dr2, n_songs)
    db = ks % dr2

    # top-n by iterative masked argmax. Sorted order IS the tie rule:
    # the first position of the global max count is the smallest
    # (song, dbin) with it — top_k's smallest-song-id tie break and the
    # dense argmax's smallest-delta tie break in one op.
    k = min(topn, n_songs)
    tops, topd, topv = [], [], []
    masked = count
    for r in range(k):
        pos = jnp.argmax(masked)
        v = masked[pos]
        got = v > 0
        s_r = jnp.where(got, song[pos], jnp.int32(0))
        # zero-vote slots mirror top_k over an all-zero tail: the
        # smallest song id not already chosen, delta_min. Each bump can
        # newly collide with an earlier-checked winner, so re-scan until
        # stable (<= len(tops) bumps possible)
        fallback = jnp.int32(0)
        for _ in range(max(1, len(tops))):
            for prev in tops:
                fallback = jnp.where(fallback == prev, fallback + 1,
                                     fallback)
        s_r = jnp.where(got, s_r, fallback)
        d_r = jnp.where(got, db[pos], jnp.int32(0)) + delta_min
        tops.append(s_r)
        topd.append(d_r.astype(jnp.int32))
        topv.append(jnp.maximum(v, 0))
        if r + 1 < k:
            masked = jnp.where(song == s_r, jnp.int32(0), masked)
    # dedup row counts for the reported songs only (valid & first, NOT
    # in_range — mirrors rows_hist): masked sums over the unsorted
    # stream, one bandwidth pass per top slot
    vf = (valid & first).astype(jnp.int32)
    rcs = [jnp.sum(jnp.where(sid == s, vf, 0)) for s in tops]

    if k < topn:
        # catalogs smaller than topn: the sparse rank pads songs/votes
        # with 0 and then gathers best_bin/rows_hist THROUGH the padded
        # song ids — padded slots carry song 0's delta and row count
        pos0 = jnp.argmax(jnp.where(song == 0, count, jnp.int32(-1)))
        has0 = count[pos0] > 0
        d0 = (jnp.where(has0, db[pos0], 0) + delta_min).astype(jnp.int32)
        rc0 = jnp.sum(jnp.where(sid == 0, vf, 0))
        for _ in range(topn - k):
            tops.append(jnp.int32(0))
            topd.append(d0)
            topv.append(jnp.int32(0))
            rcs.append(rc0)
    top_songs = jnp.stack(tops)
    top_deltas = jnp.stack(topd)
    top_votes = jnp.stack(topv)
    row_counts = jnp.stack(rcs)

    n_ranked = jnp.sum((run_start & jnp.concatenate(
        [jnp.ones(1, bool), song[1:] != song[:-1]])).astype(jnp.int32))

    # strongest challenger (see rank_votes): the 2nd-ranked song's votes
    # and the winner's 2nd-best bin
    win = top_songs[0]
    win_runs = run_start & (song == win)
    masked2 = jnp.where(song == win, jnp.int32(0), count)
    second_song = jnp.maximum(jnp.max(masked2), 0) if n_songs >= 2 \
        else jnp.int32(0)
    win_best_bin = top_deltas[0] - delta_min
    second_bin = jnp.max(jnp.where(win_runs & (db != win_best_bin),
                                   count, jnp.int32(0)))
    runner = jnp.maximum(second_song, second_bin).astype(jnp.int32)
    if n_dropped is None:
        n_dropped = jnp.int32(0)

    return RawMatch(
        top_songs.astype(jnp.int32), top_deltas, top_votes,
        row_counts, total, n_ranked,
        jnp.asarray(n_dropped, jnp.int32), runner,
    )


def _pruned_vote_rank(sid, delta, first, valid, total, n_dropped=None, *,
                      n_songs: int, delta_min: int, delta_range: int,
                      topn: int, n_candidates: int):
    """Candidate-pruned dense vote rank: O(cap) scatters, no vote sort.

    At escalated capacities the sparse rank's ``lax.sort(cap)`` can
    dominate the whole match.  This path exploits the bound that a song's best (song, delta) bin
    can hold at most as many votes as the song has expanded rows:

    1. scatter votes into a HASHED bin table (size >= 16x capacity, so
       collisions are rare); a (song, delta) bin's hashed count can only
       be inflated by collisions, so the per-song maximum of the hashed
       counts its rows land in is a TIGHT UPPER BOUND on the song's true
       best-bin votes (per-song row counts were tried first and are far
       too loose: at production scale hot keys give every song tens of
       rows while real vote bins hold a handful);
    2. take the top ``n_candidates`` songs by vote upper bound; any
       EXCLUDED song's true votes are bounded by ``excluded_max``, the
       largest excluded upper bound;
    3. build the exact dense histogram only for the candidates
       ((C, delta_range) — a few MB instead of the full
       n_songs x delta_range table the sparse path exists to avoid);
    4. certify: when ``excluded_max`` is strictly below the reported
       topn-th vote count (and <= ``runner_votes``), no excluded song
       could place in the top-n or change the strongest challenger, so
       the result is ELEMENT-IDENTICAL to the full sort rank.  When
       ``excluded_max == 0`` the pruned result is the exact dense rank
       outright (every excluded song truly has zero votes).

    Returns (RawMatch, rank_exact).  ``rank_exact`` False means the
    certificate failed (weak, tie-heavy top votes — e.g. a clip not in
    the catalog) and the RawMatch must not be used — the wrappers
    ``match_query_pruned``/``match_query_pruned_spanned`` fall back to
    the sort rank IN-PROGRAM via ``lax.cond``, so their results are
    unconditionally exact.  Correctness never depends on the heuristic
    candidate choice or the hash function.

    Certificate soundness: true votes <= hashed upper bound for every
    song (collisions only add), so excluded songs' votes are <=
    ``excluded_max``.  STRICTLY below the reported topn-th count means
    no excluded song can enter the top-n, and ties cannot reorder it
    (equality is rejected: an excluded song with equal votes and a
    smaller id would displace under the smallest-id tie rule).
    ``<= runner_votes`` keeps the challenger maximum exact (implied by
    the first condition when topn >= 2; binding for topn == 1).
    """
    cap = sid.shape[0]
    dbin = delta - delta_min
    in_range = (dbin >= 0) & (dbin < delta_range)
    vote_ok = valid & in_range

    # hashed vote-count upper bound per song. Fibonacci multiplicative
    # hash of the flat (song, delta) key into 2^m buckets; >= 16x the
    # stream length keeps expected collision inflation per bin << 1.
    # table memory capped at 2^24 bins (64 MB): past that the stream is
    # >= 1M rows and 4-16x headroom still keeps collisions rare
    m = min(24, max(18, (cap * 16 - 1).bit_length()))
    flat_key = (jnp.asarray(sid, jnp.uint32) * jnp.uint32(delta_range)
                + jnp.asarray(dbin, jnp.uint32))
    bucket = ((flat_key * jnp.uint32(0x9E3779B1))
              >> jnp.uint32(32 - m)).astype(jnp.int32)
    bucket = jnp.where(vote_ok, bucket, -1)      # mode="drop" discards
    hashed = jnp.zeros(1 << m, jnp.int32).at[bucket].add(
        vote_ok.astype(jnp.int32), mode="drop")
    row_ub = jnp.take(hashed, jnp.maximum(bucket, 0))
    ub_song = jnp.zeros(n_songs, jnp.int32).at[sid].max(
        jnp.where(vote_ok, row_ub, 0), mode="drop")

    C = min(n_candidates, n_songs)
    if n_songs > C:
        cr, cs = jax.lax.top_k(ub_song, C + 1)
        cand_songs = cs[:C]
        excluded_max = cr[C]
    else:
        cand_songs = jnp.arange(C, dtype=jnp.int32)
        excluded_max = jnp.int32(0)

    cand_slot = jnp.full(n_songs, C, jnp.int32).at[cand_songs].set(
        jnp.arange(C, dtype=jnp.int32), mode="drop")
    cslot = jnp.take(cand_slot, jnp.minimum(sid, n_songs - 1))
    live = vote_ok & (cslot < C)
    flat = jnp.where(live, cslot * delta_range + dbin, 0)
    hist = jnp.zeros(C * delta_range, jnp.int32).at[flat].add(
        live.astype(jnp.int32), mode="drop").reshape(C, delta_range)

    votes_per_cand = jnp.max(hist, axis=1)
    best_bin_cand = jnp.argmax(hist, axis=1)  # first max => smallest delta

    # scatter candidate results back onto song ids: top_k ties then keep
    # the smallest SONG id (the dense matcher's rule), not the
    # row-count-ordered candidate slot
    votes_full = jnp.zeros(n_songs, jnp.int32).at[cand_songs].set(
        votes_per_cand, mode="drop")
    best_bin_full = jnp.zeros(n_songs, jnp.int32).at[cand_songs].set(
        best_bin_cand.astype(jnp.int32), mode="drop")

    rows_hist = jnp.zeros(n_songs, jnp.int32).at[sid].add(
        (valid & first).astype(jnp.int32), mode="drop")

    k = min(topn, n_songs)
    top_votes, top_songs = jax.lax.top_k(votes_full, k)
    if k < topn:
        top_votes = jnp.pad(top_votes, (0, topn - k))
        top_songs = jnp.pad(top_songs, (0, topn - k))
    # zero-vote songs report delta_min, like the dense argmax on an
    # all-zero row (best_bin_full is 0 there by construction)
    top_deltas = jnp.take(best_bin_full, top_songs).astype(jnp.int32) \
        + delta_min
    row_counts = jnp.take(rows_hist, top_songs)
    # ub_song > 0 iff the song received >= 1 in-range vote — exact
    n_ranked = jnp.sum((ub_song > 0).astype(jnp.int32))

    # strongest challenger (see rank_votes): 2nd-ranked song + the
    # winner's 2nd-best delta bin from its candidate histogram row
    k2 = min(2, n_songs)
    tv2 = jax.lax.top_k(votes_full, k2)[0]
    second_song = tv2[1] if k2 == 2 else jnp.int32(0)
    win_slot = jnp.take(cand_slot, top_songs[0])
    top_row = jax.lax.dynamic_index_in_dim(
        hist, jnp.minimum(win_slot, C - 1), 0, keepdims=False)
    bins = jnp.arange(delta_range, dtype=jnp.int32)
    win_best = jnp.take(best_bin_full, top_songs[0])
    second_bin = jnp.max(jnp.where(bins == win_best, jnp.int32(-1),
                                   top_row))
    runner = jnp.maximum(second_song, second_bin).astype(jnp.int32)
    if n_dropped is None:
        n_dropped = jnp.int32(0)

    # exactness certificate. excluded_max == 0: every excluded song has
    # zero votes, votes_full IS the dense votes-per-song array.
    # Otherwise: strictly below the topn-th vote count means no excluded
    # song can enter (or tie into) the reported top-n, and <= runner
    # means the challenger maximum is unaffected (topn >= 2 implies the
    # second condition; it matters for topn == 1).
    rank_exact = (excluded_max == 0) | (
        (excluded_max < top_votes[k - 1]) & (excluded_max <= runner))

    raw = RawMatch(
        top_songs.astype(jnp.int32), top_deltas, top_votes,
        row_counts, total, n_ranked,
        jnp.asarray(n_dropped, jnp.int32), runner,
    )
    return raw, rank_exact


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "u_steps", "n_candidates",
                     "expand_block", "expand_runs"),
)
def match_query_pruned(
    index_arrays,
    q_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_ex: jnp.ndarray,
    q_t: jnp.ndarray,
    q_valid: jnp.ndarray,
    q_first: jnp.ndarray,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    head=None,
    uview=None,
    u_steps: int = 0,
    n_candidates: int = 256,
    expand_block: int = 0,
    expand_runs: int = 0,
    bounds=None,
):
    """``match_query_sparse`` with the candidate-pruned rank.

    ALWAYS element-identical to ``match_query_sparse`` at the same
    capacity (tested): the exactness certificate selects between the
    pruned result and an in-program ``lax.cond`` sort-rank fallback over
    the SAME expansion — one dispatch either way, and the ~O(cap log
    cap) vote sort is only paid when the certificate fails (weak,
    tie-heavy top votes).  Returns (RawMatch, rank_exact) where
    ``rank_exact`` reports which branch ran (telemetry only).

    NB under ``vmap`` the cond degrades to executing both branches —
    the batched matcher keeps the plain sort path for that reason.
    """
    check_vote_key(n_songs, delta_range)
    sid, delta, p, valid, total, n_dropped = _expand(
        index_arrays, q_hi, q_lo, q_ex, q_t, q_valid,
        match_capacity=match_capacity, offset_stride=offset_stride,
        head=head, uview=uview, u_steps=u_steps,
        expand_block=expand_block, expand_runs=expand_runs,
        bounds=bounds,
    )
    first = _take_first(q_first, p, expand_block)
    raw_p, ok = _pruned_vote_rank(
        sid, delta, first, valid, total, n_dropped,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        topn=topn, n_candidates=n_candidates,
    )
    raw = jax.lax.cond(
        ok,
        lambda: raw_p,
        lambda: _sparse_vote_rank(
            sid, delta, first, valid, total, n_dropped,
            n_songs=n_songs, delta_min=delta_min,
            delta_range=delta_range, topn=topn),
    )
    return raw, ok


@functools.partial(jax.jit, static_argnames=("u_steps", "with_bounds"))
def query_total_spanned(span_arrays, q_hi, q_lo, q_ex, q_valid, *,
                        heads=None, uviews=None, u_steps: int = 0,
                        with_bounds: bool = False):
    """``query_total`` over a spanned index: exact global matched-row
    count (sum of every span's bounds), one cheap search-only program.
    Works for both the per-span-tuple and consolidated stacked layouts;
    powers the spanned bounds-first policy.  ``with_bounds=True``
    (stacked layout only) also returns the (n_spans, Q) lb/ub so the
    fitted dispatch reuses the descent (matcher ``bounds`` argument)."""
    def span_lens(cols, head):
        lb, ub = lexi_bounds(cols[0], cols[1], cols[2], q_hi, q_lo, q_ex,
                             head=head, q_valid=q_valid)
        return jnp.sum(jnp.where(q_valid, ub - lb, 0))

    if isinstance(span_arrays[0], (tuple, list)):
        if with_bounds:
            raise ValueError("with_bounds needs the stacked layout")
        total = jnp.int32(0)
        for i, cols in enumerate(span_arrays):
            head = heads[i] if heads is not None else None
            total = total + span_lens(cols, head)
        return total
    if uviews is not None:
        from ..index.search import unique_bounds_stacked

        lb, ub = unique_bounds_stacked(uviews, q_hi, q_lo, q_ex, q_valid,
                                       steps=u_steps)
    elif heads is None:
        lb, ub = jax.vmap(lambda c: lexi_bounds(
            c[0], c[1], c[2], q_hi, q_lo, q_ex, head=None,
            q_valid=q_valid))(span_arrays[:3])
    else:
        lb, ub = jax.vmap(lambda c, h: lexi_bounds(
            c[0], c[1], c[2], q_hi, q_lo, q_ex, head=h,
            q_valid=q_valid))(span_arrays[:3], heads)
    total = jnp.sum(jnp.where(q_valid[None, :], ub - lb, 0))
    if with_bounds:
        return total, lb, ub
    return total


def _expand_spans(span_arrays, heads, q_hi, q_lo, q_ex, q_t, q_valid,
                  q_first, *, match_capacity: int, offset_stride: int):
    """Expand a query against every span; concatenate the vote streams.

    Returns (sid, delta, first, valid, total, span_max, n_dropped): flat
    arrays of length n_spans * match_capacity, the exact global match
    count, the largest single-span count (the overflow/retry signal —
    each span's expansion clamps independently at match_capacity), and
    the summed budget-excluded run count across spans.
    """
    parts = []
    totals = []
    drops = []
    for i, arrs in enumerate(span_arrays):
        head = heads[i] if heads is not None else None
        sid, delta, p, valid, total, nd = _expand(
            arrs, q_hi, q_lo, q_ex, q_t, q_valid,
            match_capacity=match_capacity, offset_stride=offset_stride,
            head=head,
        )
        parts.append((sid, delta, jnp.take(q_first, p), valid))
        totals.append(total)
        drops.append(nd)
    sid = jnp.concatenate([x[0] for x in parts])
    delta = jnp.concatenate([x[1] for x in parts])
    first = jnp.concatenate([x[2] for x in parts])
    valid = jnp.concatenate([x[3] for x in parts])
    total = functools.reduce(jnp.add, totals)
    span_max = functools.reduce(jnp.maximum, totals)
    n_dropped = functools.reduce(jnp.add, drops)
    return sid, delta, first, valid, total, span_max, n_dropped


def _expand_stacked(stacked_arrays, heads, q_hi, q_lo, q_ex, q_t, q_valid,
                    q_first, *, match_capacity: int, offset_stride: int,
                    uviews=None, u_steps: int = 0, expand_block: int = 0,
                    expand_runs: int = 0, bounds=None):
    """``_expand_spans`` over a CONSOLIDATED (n_spans, span_rows) layout,
    with ONE global ``match_capacity`` budget shared across spans.

    The per-span variant pays n_spans x match_capacity expansion gathers
    and hands the vote rank an n_spans-x-longer stream even though the
    real row count is the same catalog split S ways.  Here the descents stay vmapped over the span axis
    (S x the lanes in one latency-bound random-HBM round), but the runs
    of ALL spans then share one shortest-first budget (the _expand
    policy) and gather through the flat (n_spans * span_rows) view of
    the stacked columns — expansion cost and vote-stream length match
    the single-index path regardless of span count.

    Returns (sid, delta, first, valid, total, clamp_signal, n_dropped);
    the clamp signal is the global total (the budget is global, so
    "needs escalation" is exactly ``total > match_capacity`` — callers
    compare it to the capacity just like the per-span max).
    """
    n_spans, span_rows = stacked_arrays[0].shape
    if n_spans * span_rows >= 2 ** 31:
        raise ValueError(
            f"stacked layout {n_spans} x {span_rows} rows >= 2^31: flat "
            "int32 row indices would overflow — split the catalog across "
            "devices/hosts instead of stacking past ~2.1B rows")
    n_pairs = q_hi.shape[0]

    def span_search(span_cols, head):
        return lexi_bounds(span_cols[0], span_cols[1], span_cols[2],
                           q_hi, q_lo, q_ex, head=head, q_valid=q_valid)

    if bounds is not None:
        lb, ub = bounds
    elif uviews is not None:
        # stacked unique-key view (build_unique_view_spans): ONE
        # fixed-round descent per span over the deduplicated key table,
        # upper bounds free from the cdf — hot runs cannot inflate the
        # round count and the searched bytes shrink ~rows/key-fold
        from ..index.search import unique_bounds_stacked

        lb, ub = unique_bounds_stacked(uviews, q_hi, q_lo, q_ex, q_valid,
                                       steps=u_steps)
    elif heads is None:
        lb, ub = jax.vmap(lambda c: span_search(c, None))(stacked_arrays)
    else:
        lb, ub = jax.vmap(span_search)(stacked_arrays, heads)

    # flatten runs span-major: run r = s * n_pairs + pair
    lens = jnp.where(q_valid[None, :], ub - lb, 0).reshape(-1)
    base = (jnp.arange(n_spans, dtype=jnp.int32)[:, None] * span_rows
            + lb).reshape(-1)

    if expand_block:
        # block-gather over the flat stacked payload (runs never
        # straddle spans: span_rows is a pow2 multiple of the block).
        # A query key matches in EVERY span, so the nonempty-run
        # budget scales with the span count.
        if offset_stride == 0:
            raise ValueError("blocked stacked expansion needs the "
                             "packed payload layout")
        if span_rows % expand_block:
            raise ValueError(
                f"span_rows {span_rows} not a multiple of the block "
                f"size {expand_block}")
        sid, delta, pair, valid, total, n_dropped = _blocked_expand_core(
            stacked_arrays[3], base, base + lens, lens, q_t,
            block_size=expand_block, match_capacity=match_capacity,
            offset_stride=offset_stride,
            max_runs=expand_runs * n_spans if expand_runs else 0,
            pair_mod=n_pairs)
        # per-block gather + broadcast, not a full-stream element gather
        # (see _take_first)
        first = _take_first(q_first, pair, expand_block)
        return sid, delta, first, valid, total, total, n_dropped

    total = jnp.sum(lens)

    # global shortest-first run budget (see _expand)
    order = jnp.argsort(lens)
    lens_s = jnp.take(lens, order)
    base_s = jnp.take(base, order)
    cum = jnp.cumsum(lens_s)
    included = cum <= match_capacity
    n_dropped = jnp.sum(((lens_s > 0) & ~included).astype(jnp.int32))
    lens_inc = jnp.where(included, lens_s, 0)
    cum_inc = jnp.cumsum(lens_inc)
    total_inc = cum_inc[-1]

    v = jnp.arange(match_capacity, dtype=jnp.int32)
    marks = jnp.zeros(match_capacity, jnp.int32).at[cum_inc].add(
        1, mode="drop")
    p = jnp.cumsum(marks)
    p = jnp.minimum(p, lens.shape[0] - 1)
    prev = jnp.where(p > 0, jnp.take(cum_inc, p - 1), 0)
    row = jnp.take(base_s, p) + (v - prev)
    valid = v < total_inc
    pair = jnp.take(order, p) % n_pairs

    safe_row = jnp.where(valid, row, 0)
    if offset_stride:
        packed = jnp.take(stacked_arrays[3].reshape(-1), safe_row)
        sid = (packed // offset_stride).astype(jnp.int32)
        doff = (packed % offset_stride).astype(jnp.int32)
    else:
        sid = jnp.take(stacked_arrays[3].reshape(-1),
                       safe_row).astype(jnp.int32)
        doff = jnp.take(stacked_arrays[4].reshape(-1),
                        safe_row).astype(jnp.int32)
    delta = doff - jnp.take(q_t, pair).astype(jnp.int32)
    first = jnp.take(q_first, pair)
    return sid, delta, first, valid, total, total, n_dropped


def _expand_any_spans(span_arrays, heads, q_hi, q_lo, q_ex, q_t, q_valid,
                      q_first, *, match_capacity: int, offset_stride: int,
                      uviews=None, u_steps: int = 0, expand_block: int = 0,
                      expand_runs: int = 0, bounds=None):
    """Dispatch: per-span column tuples vs consolidated stacked layout.

    Trace-time structural dispatch — the two layouts are distinct
    pytrees, so each gets its own compiled program. ``uviews`` (a
    stacked ``build_unique_view_spans`` table) applies to the stacked
    layout only."""
    if isinstance(span_arrays[0], (tuple, list)):
        # per-span tuples (pre-consolidate): no blocked variant — spans
        # expand independently with per-span budgets
        if bounds is not None:
            raise ValueError("precomputed bounds need the stacked layout")
        return _expand_spans(span_arrays, heads, q_hi, q_lo, q_ex, q_t,
                             q_valid, q_first,
                             match_capacity=match_capacity,
                             offset_stride=offset_stride)
    return _expand_stacked(span_arrays, heads, q_hi, q_lo, q_ex, q_t,
                           q_valid, q_first, match_capacity=match_capacity,
                           offset_stride=offset_stride, uviews=uviews,
                           u_steps=u_steps, expand_block=expand_block,
                           expand_runs=expand_runs, bounds=bounds)


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "u_steps", "vote_rank",
                     "expand_block", "expand_runs", "with_bounds"),
)
def match_query_sparse_spanned(
    span_arrays,
    q_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_ex: jnp.ndarray,
    q_t: jnp.ndarray,
    q_valid: jnp.ndarray,
    q_first: jnp.ndarray,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    heads=None,
    uviews=None,
    u_steps: int = 0,
    vote_rank: str = "sort",
    expand_block: int = 0,
    expand_runs: int = 0,
    bounds=None,
    with_bounds: bool = False,
):
    """``match_query_sparse`` over a spanned index.

    A ``SpannedDeviceStore`` holds the catalog as several independently
    sorted spans (bounded sorts at ingest — see index/devmerge.py); a
    row for one (song, delta) may live in any span, so every span is
    searched and the expanded vote streams are counted TOGETHER — the
    sort-based run-length count coalesces equal vote keys regardless of
    which span produced them, making the result element-identical to one
    big sorted index (tested).  This is the single-chip analog of the
    reference's Elasticsearch shard knob (``elastic_database.py:42,80``).

    ``span_arrays`` is either a tuple of per-span 4-column tuples (live
    ingest layout) or a 4-tuple of (n_spans, span_rows) stacked arrays
    (``SpannedDeviceStore.consolidate()`` serving layout — one vmapped
    search instead of an unrolled span loop); ``heads`` correspondingly
    a tuple of per-span heads or one (n_spans, 2^bits + 1) stack.

    Returns (RawMatch, span_max): ``total_rows`` sums the spans' exact
    counts; ``span_max`` is the clamp/retry signal the caller compares
    against ``match_capacity`` — the largest per-span count for the
    per-span-tuple layout (each span clamps independently), the global
    total for the stacked layout (one shared budget, see
    ``_expand_stacked``).  Either way "``span_max`` <= capacity" means
    the expansion was exhaustive and a larger capacity fits everything.

    ``with_bounds=True`` (stacked layout only) additionally returns the
    (n_spans, Q) lb/ub — computed once and shared with the expansion —
    so the spanned decided-first policy's fitted re-dispatch can reuse
    the descent (see ``match_query_sparse``'s twin parameter).
    """
    check_vote_key(n_songs, delta_range)
    stacked = not isinstance(span_arrays[0], (tuple, list))
    if with_bounds and not stacked:
        raise ValueError("with_bounds needs the stacked layout")
    if with_bounds and bounds is None:
        if uviews is not None:
            from ..index.search import unique_bounds_stacked

            bounds = unique_bounds_stacked(uviews, q_hi, q_lo, q_ex,
                                           q_valid, steps=u_steps)
        elif heads is None:
            bounds = jax.vmap(lambda c: lexi_bounds(
                c[0], c[1], c[2], q_hi, q_lo, q_ex, head=None,
                q_valid=q_valid))(span_arrays[:3])
        else:
            bounds = jax.vmap(lambda c, h: lexi_bounds(
                c[0], c[1], c[2], q_hi, q_lo, q_ex, head=h,
                q_valid=q_valid))(span_arrays[:3], heads)
    sid, delta, first, valid, total, span_max, n_dropped = \
        _expand_any_spans(
            span_arrays, heads, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
            match_capacity=match_capacity, offset_stride=offset_stride,
            uviews=uviews, u_steps=u_steps, expand_block=expand_block,
            expand_runs=expand_runs, bounds=bounds,
        )
    blocked = expand_block and stacked
    raw = _rank_by_name(vote_rank)(
        sid, delta, first, valid, total, n_dropped,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        topn=topn, prefix=match_capacity if blocked else 0,
    )
    if with_bounds:
        return raw, span_max, bounds[0], bounds[1]
    return raw, span_max


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "n_candidates", "u_steps"),
)
def match_query_pruned_spanned(
    span_arrays,
    q_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_ex: jnp.ndarray,
    q_t: jnp.ndarray,
    q_valid: jnp.ndarray,
    q_first: jnp.ndarray,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    heads=None,
    n_candidates: int = 256,
    uviews=None,
    u_steps: int = 0,
):
    """``match_query_sparse_spanned`` with the candidate-pruned rank.

    ALWAYS element-identical to ``match_query_sparse_spanned`` (same
    in-program ``lax.cond`` sort fallback as ``match_query_pruned``);
    the concatenated span vote streams feed ``_pruned_vote_rank``
    exactly as they feed the sort rank — votes for one (song, delta)
    coalesce in the candidate histogram regardless of which span
    produced them.  Returns (RawMatch, span_max, rank_exact).
    """
    check_vote_key(n_songs, delta_range)
    sid, delta, first, valid, total, span_max, n_dropped = \
        _expand_any_spans(
            span_arrays, heads, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
            match_capacity=match_capacity, offset_stride=offset_stride,
            uviews=uviews, u_steps=u_steps,
        )
    raw_p, ok = _pruned_vote_rank(
        sid, delta, first, valid, total, n_dropped,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        topn=topn, n_candidates=n_candidates,
    )
    raw = jax.lax.cond(
        ok,
        lambda: raw_p,
        lambda: _sparse_vote_rank(
            sid, delta, first, valid, total, n_dropped,
            n_songs=n_songs, delta_min=delta_min,
            delta_range=delta_range, topn=topn),
    )
    return raw, span_max, ok

"""Batched multi-query matching: many clips against the index in one program.

The reference answers one query at a time over a DB socket (thread pools
just parallelize the SELECT batches, ``recognizer_thread.py:290-298``).
On an accelerator the natural form is a vmap over the whole query batch:
every clip's binary searches, vote expansion and histogram reduce run in
one compiled program, amortizing dispatch and filling the device — the serving
path for high-QPS deployments.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .lookup import (match_local, match_query_pruned, match_query_sparse,
                     query_total, rank_votes, RawMatch, _expand,
                     _expand_any_spans, _pruned_vote_rank, _take_first)


@functools.partial(jax.jit, static_argnames=("u_steps",))
def query_totals_batched(index_arrays, q_hi, q_lo, q_ex, q_valid, *,
                         head=None, uview=None, u_steps: int = 0):
    """Vmapped ``lookup.query_total``: exact per-clip matched-row counts
    AND per-lane bounds for a (Bq, Q) query batch in one cheap
    search-only program — the batched bounds-first probe
    (api.recognize_batch picks the whole batch's fitting tier from the
    totals instead of paying a base-tier dispatch that production-scale
    clips mostly overflow, and feeds the (Bq, Q) bounds back into the
    fitted dispatch so the search never runs twice).

    Returns (totals, lb, ub)."""
    def one(hi, lo, ex, v):
        return query_total(index_arrays, hi, lo, ex, v, head=head,
                           uview=uview, u_steps=u_steps,
                           with_bounds=True)
    return jax.vmap(one)(q_hi, q_lo, q_ex, q_valid)


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "sparse", "u_steps",
                     "rank_candidates", "vote_rank", "expand_block",
                     "expand_runs"),
)
def match_queries_batched(
    index_arrays,
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,   # each (Bq, Q)
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    sparse: bool = None,
    head=None,
    uview=None,
    u_steps: int = 0,
    rank_candidates: int = 0,
    vote_rank: str = "pruned",
    expand_block: int = 0,
    expand_runs: int = 0,
    bounds=None,
) -> RawMatch:
    """Match a (Bq, Q) batch of padded queries; returns batched RawMatch.

    ``sparse`` (default: auto past 16M histogram bins) vmaps the
    sort-based matcher instead of the dense histogram — a (Bq, n_songs,
    delta_range) histogram stack is ~4 GB per batch at 12K songs.

    ``vote_rank="pruned"`` with ``rank_candidates`` > 0 (sparse only)
    vmaps the candidate-pruned rank instead of the vote sort and returns
    ``(RawMatch, oks)`` where ``oks`` is the per-clip exactness
    certificate.  Under vmap an in-program cond would execute BOTH
    branches, so there is no fused fallback here: a clip whose
    certificate fails must be re-dispatched through the solo matcher by
    the caller (api.recognize_batch does) — its RawMatch row is NOT
    exact.  ``vote_rank="scan"``/``"sort"`` return a plain RawMatch and
    are unconditionally exact ("scan" also vmaps without the per-clip
    hashed tables the pruned rank allocates).
    """
    if sparse is None:
        sparse = n_songs * delta_range > 16_000_000

    def one(hi, lo, ex, t, valid, first, bnd):
        if sparse and vote_rank == "pruned" and rank_candidates > 0:
            sid, delta, p, valid_s, total, n_dropped = _expand(
                index_arrays, hi, lo, ex, t, valid,
                match_capacity=match_capacity,
                offset_stride=offset_stride, head=head,
                uview=uview, u_steps=u_steps,
                expand_block=expand_block, expand_runs=expand_runs,
                bounds=bnd,
            )
            return _pruned_vote_rank(
                sid, delta, _take_first(first, p, expand_block),
                valid_s, total, n_dropped,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, topn=topn,
                n_candidates=rank_candidates,
            )
        if sparse:
            return match_query_sparse(
                index_arrays, hi, lo, ex, t, valid, first,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=match_capacity,
                topn=topn, offset_stride=offset_stride, head=head,
                uview=uview, u_steps=u_steps,
                vote_rank=vote_rank if vote_rank != "pruned" else "sort",
                expand_block=expand_block, expand_runs=expand_runs,
                bounds=bnd,
            )
        hist, rows_hist, total, n_dropped = match_local(
            index_arrays, hi, lo, ex, t, valid, first,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity, offset_stride=offset_stride,
            head=head, uview=uview, u_steps=u_steps,
        )
        return rank_votes(hist, rows_hist, total, delta_min=delta_min,
                          topn=topn, n_dropped=n_dropped)

    return jax.vmap(one)(q_hi, q_lo, q_ex, q_t, q_valid, q_first, bounds)


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "topn", "offset_stride", "rank_candidates", "u_steps",
                     "vote_rank", "expand_block", "expand_runs"),
)
def match_queries_batched_spanned(
    span_arrays,
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,   # each (Bq, Q)
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    heads=None,
    rank_candidates: int = 0,
    uviews=None,
    u_steps: int = 0,
    vote_rank: str = "pruned",
    expand_block: int = 0,
    expand_runs: int = 0,
):
    """``match_queries_batched`` against a spanned index (per-span tuples
    or the consolidated stacked layout — lookup.match_query_sparse_spanned
    dispatches).  Returns (batched RawMatch, (Bq,) span_max): the retry /
    overflow signal is per clip, since every span clamps its expansion
    independently at ``match_capacity`` (the global total for the
    stacked layout's shared budget).

    ``rank_candidates`` > 0 returns (RawMatch, span_max, oks) with the
    per-clip exactness certificate — same contract as
    ``match_queries_batched``: a failed clip's row is NOT exact and the
    caller re-dispatches it solo."""
    from .lookup import match_query_sparse_spanned

    def one(hi, lo, ex, t, valid, first):
        if vote_rank == "pruned" and rank_candidates > 0:
            sid, delta, first_s, valid_s, total, span_max, n_dropped = \
                _expand_any_spans(
                    span_arrays, heads, hi, lo, ex, t, valid, first,
                    match_capacity=match_capacity,
                    offset_stride=offset_stride,
                    uviews=uviews, u_steps=u_steps,
                    expand_block=expand_block, expand_runs=expand_runs,
                )
            raw, ok = _pruned_vote_rank(
                sid, delta, first_s, valid_s, total, n_dropped,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, topn=topn,
                n_candidates=rank_candidates,
            )
            return raw, span_max, ok
        return match_query_sparse_spanned(
            span_arrays, hi, lo, ex, t, valid, first,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity, topn=topn,
            offset_stride=offset_stride, heads=heads,
            uviews=uviews, u_steps=u_steps,
            vote_rank=vote_rank if vote_rank != "pruned" else "sort",
            expand_block=expand_block, expand_runs=expand_runs,
        )

    return jax.vmap(one)(q_hi, q_lo, q_ex, q_t, q_valid, q_first)

"""Apriori early-exit matching.

Reproduces the reference's early-termination matcher
(``recognizer_apriori.py:245-310``): query hashes are processed in
batches; after each batch the partial per-song matched-row counts are
ranked and the sweep stops as soon as the leader has more than twice the
runner-up's matches (``:303``: ``if top1/2 > top2: break``).

Device design: the vote histogram and row counts accumulate in HBM
across batches (one jitted step per batch); only the two leading row
counts come back to the host for the margin test, so an early exit skips
the remaining batches' binary searches entirely.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lookup import check_vote_key, match_local, rank_votes, RawMatch
from .prepare import QueryPairs


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "offset_stride"),
)
def _apriori_step(
    index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
    hist, rows_hist, total, n_dropped,
    *, n_songs: int, delta_min: int, delta_range: int, match_capacity: int,
    offset_stride: int = 0, head=None,
):
    h, r, t, nd = match_local(
        index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, q_first,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        match_capacity=match_capacity, offset_stride=offset_stride,
        head=head,
    )
    hist = hist + h
    rows_hist = rows_hist + r
    total = total + t
    n_dropped = n_dropped + nd
    # the reference ranks the partial result by aligned votes and then
    # compares the top-2 songs' dedup row counts (HASHES_MATCHED of the
    # align_matches output, recognizer_apriori.py:296-310) — NOT the two
    # largest row counts themselves
    votes_per_song = jnp.max(hist, axis=1)
    k = min(2, votes_per_song.shape[0])
    _, top_songs = jax.lax.top_k(votes_per_song, k)
    top2 = jnp.take(rows_hist, top_songs)
    if k < 2:
        top2 = jnp.pad(top2, (0, 2 - k))
    return hist, rows_hist, total, n_dropped, top2


@functools.partial(
    jax.jit, static_argnames=("delta_min", "topn"),
)
def _apriori_rank(hist, rows_hist, total, n_dropped, *, delta_min: int,
                  topn: int):
    return rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                      n_dropped=n_dropped)


def match_query_apriori(
    index_arrays,
    q: QueryPairs,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    batch_size: int = 1024,
    offset_stride: int = 0,
    head=None,
) -> Tuple[RawMatch, int, bool]:
    """Batched match with the 2x-leader early exit.

    Returns (RawMatch, batches_used, clamped). ``total_rows`` is the
    TRUE accumulated match count across batches; ``clamped`` is True iff
    any single batch expanded past match_capacity (the only way votes
    can actually be dropped here — the accumulated total legitimately
    exceeds match_capacity on multi-batch queries, so callers must NOT
    infer overflow from it). Results are identical to the full match
    whenever no early exit triggers; with an exit they reflect the
    partial scan exactly like the reference's apriori mode.
    """
    check_vote_key(n_songs, delta_range)
    # batch over the TRUE pair count: the prepared query is padded to a
    # pow2 bucket, and a pure-padding batch is a full expansion program
    # plus a host round trip that can learn nothing
    n = max(int(q.n_pairs), 1)
    hist = jnp.zeros((n_songs, delta_range), jnp.int32)
    rows_hist = jnp.zeros(n_songs, jnp.int32)
    total = jnp.int32(0)
    n_dropped = jnp.int32(0)

    n_batches = max(1, -(-n // batch_size))
    used = 0
    clamped = False
    prev_total = 0
    for b in range(n_batches):
        sl = slice(b * batch_size, (b + 1) * batch_size)

        def pad(a):
            chunk = a[sl]
            if len(chunk) < batch_size:
                chunk = np.pad(chunk, (0, batch_size - len(chunk)))
            return jnp.asarray(chunk)

        hist, rows_hist, total, n_dropped, top2 = _apriori_step(
            index_arrays,
            pad(q.hi), pad(q.lo), pad(q.ex), pad(q.t),
            pad(q.valid), pad(q.first),
            hist, rows_hist, total, n_dropped,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity, offset_stride=offset_stride,
            head=head,
        )
        used += 1
        top2_host, cur_total = jax.device_get((top2, total))
        cur_total = int(cur_total)
        if cur_total - prev_total > match_capacity:
            clamped = True        # this batch's expansion hit capacity
        prev_total = cur_total
        # reference margin rule (recognizer_apriori.py:303): the
        # vote-ranked leader's matched rows halved still beat the
        # vote-ranked runner-up's
        if top2_host[0] / 2.0 > top2_host[1] and used < n_batches:
            break

    raw = _apriori_rank(hist, rows_hist, total, n_dropped,
                        delta_min=delta_min, topn=topn)
    return jax.device_get(raw), used, clamped


@functools.partial(
    jax.jit,
    static_argnames=("n_songs", "delta_min", "delta_range", "match_capacity",
                     "offset_stride", "batch_size", "topn"),
)
def _apriori_device_loop(
    index_arrays, q_hi, q_lo, q_ex, q_t, q_valid, q_first, n_batches,
    *, n_songs: int, delta_min: int, delta_range: int, match_capacity: int,
    offset_stride: int, batch_size: int, topn: int,
    head=None,
):
    """The whole apriori sweep as ONE device program.

    The host-loop variant above pays a host round trip per margin
    check, which can eat the saved batches (benchmarks/apriori_timing.py
    measures when). Here the batch loop runs in a
    ``lax.while_loop`` whose condition embeds the reference's 2x-leader
    rule (``recognizer_apriori.py:303``) — an early exit skips the
    remaining batches' searches and expansions entirely, with zero host
    synchronization until the final ranked result.

    ``n_batches`` is a traced scalar (the query arrays are padded to a
    power-of-two batch count): clips of any length reuse O(log) compiled
    programs instead of one per batch count."""
    from jax import lax

    def batch_of(a, b):
        return lax.dynamic_slice_in_dim(a, b * batch_size, batch_size)

    def cond(st):
        return jnp.logical_and(st[0] < n_batches, jnp.logical_not(st[1]))

    def body(st):
        b, _stop, hist, rows_hist, total, nd_acc, used, clamped = st
        h, r, t, nd = match_local(
            index_arrays,
            batch_of(q_hi, b), batch_of(q_lo, b), batch_of(q_ex, b),
            batch_of(q_t, b), batch_of(q_valid, b), batch_of(q_first, b),
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity, offset_stride=offset_stride,
            head=head,
        )
        hist = hist + h
        rows_hist = rows_hist + r
        total = total + t
        nd_acc = nd_acc + nd
        clamped = jnp.logical_or(clamped, t > match_capacity)
        # reference margin rule on the partial result: vote-ranked top-2
        # songs' dedup row counts, leader halved still ahead
        votes_per_song = jnp.max(hist, axis=1)
        k = min(2, n_songs)
        _, top_songs = lax.top_k(votes_per_song, k)
        top2 = jnp.take(rows_hist, top_songs).astype(jnp.float32)
        if k < 2:
            top2 = jnp.pad(top2, (0, 2 - k))
        stop = top2[0] / 2.0 > top2[1]
        return b + 1, stop, hist, rows_hist, total, nd_acc, used + 1, clamped

    init = (
        jnp.int32(0), jnp.bool_(False),
        jnp.zeros((n_songs, delta_range), jnp.int32),
        jnp.zeros(n_songs, jnp.int32), jnp.int32(0), jnp.int32(0),
        jnp.int32(0), jnp.bool_(False),
    )
    _, _, hist, rows_hist, total, nd_acc, used, clamped = lax.while_loop(
        cond, body, init)
    raw = rank_votes(hist, rows_hist, total, delta_min=delta_min, topn=topn,
                     n_dropped=nd_acc)
    return raw, used, clamped


def match_query_apriori_ondevice(
    index_arrays,
    q: QueryPairs,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    batch_size: int = 1024,
    offset_stride: int = 0,
    head=None,
) -> Tuple[RawMatch, int, bool]:
    """``match_query_apriori`` semantics in one device dispatch.

    Identical returns (RawMatch, batches_used, clamped) and identical
    results batch for batch — only the margin test moves on device."""
    check_vote_key(n_songs, delta_range)
    n = max(int(q.n_pairs), 1)
    n_batches = max(1, -(-n // batch_size))
    # pad the ARRAYS to a pow2 batch count (bounded program set); the
    # traced n_batches operand keeps the loop's trip count exact
    n_cap = 1 << (n_batches - 1).bit_length()
    L = n_cap * batch_size

    def pad(a, fill=0):
        a = np.asarray(a[:n])
        return jnp.asarray(np.pad(a, (0, L - len(a)),
                                  constant_values=fill))

    raw, used, clamped = _apriori_device_loop(
        index_arrays,
        pad(q.hi), pad(q.lo), pad(q.ex), pad(q.t),
        pad(q.valid, False), pad(q.first, False), jnp.int32(n_batches),
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        match_capacity=match_capacity, offset_stride=offset_stride,
        batch_size=batch_size, topn=topn, head=head,
    )
    return jax.device_get(raw), int(used), bool(clamped)

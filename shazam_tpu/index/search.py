"""Vectorized lexicographic binary search over 80-bit fingerprint keys.

The HBM index stores keys as three parallel uint32 arrays (hi, lo, ex16)
sorted lexicographically. Lookups are lane-parallel binary searches: every
query walks ceil(log2 N) rounds of gather + compare, all queries at once.
This replaces the reference's ``SELECT ... WHERE hash IN (...)`` round
trips (``mysql_database.py:82-86``, ``recognizer.py:252-257``) with a few
dozen fused HBM gathers.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _lt(a_hi, a_lo, a_ex, b_hi, b_lo, b_ex):
    """Lexicographic (hi, lo, ex) <."""
    return (a_hi < b_hi) | (
        (a_hi == b_hi) & ((a_lo < b_lo) | ((a_lo == b_lo) & (a_ex < b_ex)))
    )


def _le_q(m_hi, m_lo, m_ex, q_hi, q_lo, q_ex):
    """keep-left predicate for the upper bound: key[mid] <= q."""
    return ~_lt(q_hi, q_lo, q_ex, m_hi, m_lo, m_ex)


FENCE_STRIDE = 512  # span refined by the bounded upper-bound pre-search

HEAD_BITS = 20  # bucket-CDF head resolution: 2^20 buckets, 4 MB


def head_bits_for(n: int) -> int:
    """Head resolution targeting ~64 rows/bucket, capped at HEAD_BITS."""
    if n < 2:
        return 1
    return max(1, min(HEAD_BITS, int(math.log2(n)) - 6))


@functools.partial(jax.jit, static_argnames=("bits",))
def build_head(k_hi: jnp.ndarray, bits: int = HEAD_BITS) -> jnp.ndarray:
    """Bucketed CDF over the sorted hi keys: head[b] = first row with
    (hi >> (32-bits)) >= b, shape (2^bits + 1,).

    One build-time pass buys EXACT per-lane search windows at query
    time — head[b] .. head[b+1] brackets every key of bucket b
    regardless of the key distribution, so hyper-common hash runs
    (10K-70K duplicate rows in production catalogs) cost only their own
    log2(run) descent rounds instead of defeating an interpolation
    estimate (the +-6 sigma interpolation window misses on ~every
    real-catalog batch once hot runs shift the CDF, falling back to
    full descents).

    Built with a lane-parallel searchsorted (pure gathers), not a
    bincount scatter over every index row.
    """
    n = k_hi.shape[0]
    shift = jnp.uint32(32 - bits)
    bounds = jnp.arange(1, 1 << bits, dtype=jnp.uint32) << shift
    inner = jnp.searchsorted(k_hi, bounds, side="left").astype(jnp.int32)
    return jnp.concatenate(
        [jnp.zeros(1, jnp.int32), inner, jnp.full(1, n, jnp.int32)])


def _head_spans(head, q_hi):
    """Exact per-lane [lo, hi) search windows from the bucket-CDF head."""
    bits = (head.shape[0] - 1).bit_length() - 1
    b = (q_hi >> jnp.uint32(32 - bits)).astype(jnp.int32)
    return jnp.take(head, b), jnp.take(head, b + 1)


HEAD_MIN_ROWS = 4096  # below this the plain descent already wins


def maybe_build_head(k_hi: jnp.ndarray):
    """The one head policy: build at >= HEAD_MIN_ROWS, ~64 rows/bucket.

    Callers (api._ensure_head, ShardedCatalog, multihost, benches) share
    this so threshold/resolution tuning happens in exactly one place.
    Stacked per-shard variants go through :func:`stacked_head_bits` —
    same threshold and resolution rule.
    """
    bits = stacked_head_bits(k_hi.shape[0])
    if bits is None:
        return None
    return build_head(k_hi, bits=bits)


def stacked_head_bits(rows: int):
    """Head policy for per-shard stacked builds (vmapped callers own the
    build itself — sharded regimes need custom out_shardings): None
    below HEAD_MIN_ROWS, else the ~64 rows/bucket resolution."""
    if rows < HEAD_MIN_ROWS:
        return None
    return head_bits_for(rows)


def _descend_step(keys, queries, keep_left_on):
    """One lane-parallel gather+compare halving step, shared by the
    fixed-round and dynamic descents."""
    k_hi, k_lo, k_ex = keys
    q_hi, q_lo, q_ex = queries

    def step(lo, hi):
        mid = (lo + hi) >> 1
        m_hi = jnp.take(k_hi, mid)
        m_lo = jnp.take(k_lo, mid)
        m_ex = jnp.take(k_ex, mid)
        go_right = keep_left_on(m_hi, m_lo, m_ex, q_hi, q_lo, q_ex) & (lo < hi)
        new_lo = jnp.where(go_right, mid + 1, lo)
        new_hi = jnp.where(go_right | (lo >= hi), hi, mid)
        return new_lo, new_hi

    return step


def _search_rounds(keys, queries, keep_left_on, lo, hi, steps):
    """`steps` rounds of lane-parallel gather+compare on [lo, hi]."""
    step = _descend_step(keys, queries, keep_left_on)
    lo, hi = jax.lax.fori_loop(
        0, steps, lambda _, c: step(*c), (lo, hi))
    return lo


def _search_span_dyn(keys, queries, keep_left_on, lo, hi):
    """Lane-parallel descent over per-lane [lo, hi] spans, running only
    as many rounds as the widest span needs (spans are data-dependent
    when seeded from the bucket head — a hot-run lane may need 17 rounds
    while typical lanes need 7)."""
    step = _descend_step(keys, queries, keep_left_on)
    lo, hi = jax.lax.while_loop(
        lambda c: jnp.any(c[0] < c[1]), lambda c: step(*c), (lo, hi))
    return lo


def _binary_search(keys, queries, keep_left_on, q_valid=None):
    """Shared lower/upper bound machinery, interpolation-seeded.

    keep_left_on(k_mid, q) -> True where the search range should move right
    (i.e. mid is strictly before the boundary).

    Random gathers into the full key arrays are the latency hot-spot at
    13M+ rows (~25 rounds x 3 gathers/lane), and each round's gathers
    are dependent random reads, so even a compact fence of every 512th
    key costs a full round per step. Fingerprint keys are SHA-1 prefixes => uniform in
    [0, 2^32), so the boundary row is ~Binomial(n, hi/2^32): the key
    VALUE predicts the row to ~sqrt(n)/2 std and one multiply replaces
    the ~19-round descent. The +-6 sigma window is
    verified exactly per lane; any miss (non-uniform keys) escapes to a
    full descent under a batch-level ``lax.cond`` and the per-lane
    results are merged, so correctness never depends on the key
    distribution.
    """
    k_hi = keys[0]
    n = k_hi.shape[0]
    q_shape = queries[0].shape

    if n <= 8 * FENCE_STRIDE:
        lo = jnp.zeros(q_shape, jnp.int32)
        hi = jnp.full(q_shape, n, jnp.int32)
        steps = max(1, (n - 1).bit_length() if n > 0 else 1) + 1
        return _search_rounds(keys, queries, keep_left_on, lo, hi, steps)

    q_hi = queries[0]
    # f32 relative error ~2^-24 adds < n/2^24 rows of est error —
    # negligible vs the >=4096-row window at any n that reaches here
    est = (q_hi.astype(jnp.float32)
           * jnp.float32(n / float(2**32))).astype(jnp.int32)
    w = 1 << max(12, math.ceil(math.log2(6.0 * math.sqrt(n) / 2.0)))
    lo_w = jnp.clip(est - w, 0, n)
    hi_w = jnp.clip(est + w, 0, n)
    # the window brackets the boundary iff key[lo_w-1] is strictly before
    # it (or the window starts at 0) and key[hi_w] is not (or it ends at n)
    pl = jnp.maximum(lo_w - 1, 0)
    ph = jnp.minimum(hi_w, n - 1)

    def take3(p):
        return (jnp.take(keys[0], p), jnp.take(keys[1], p),
                jnp.take(keys[2], p))

    below_ok = (lo_w == 0) | keep_left_on(*take3(pl), *queries)
    above_ok = (hi_w == n) | ~keep_left_on(*take3(ph), *queries)
    ok = below_ok & above_ok
    if q_valid is not None:
        # padding lanes (all-ones keys equal to a sentinel tail) fail
        # the window check and would force the batch-wide full descent
        # on EVERY padded batch; their bounds are discarded by the
        # caller, so count them as bracketed
        ok = ok | ~q_valid
    steps = (2 * w - 1).bit_length() + 1
    full_steps = max(1, (n - 1).bit_length()) + 1

    def fast(_):
        return _search_rounds(keys, queries, keep_left_on, lo_w, hi_w, steps)

    def slow(_):
        full = _search_rounds(
            keys, queries, keep_left_on,
            jnp.zeros(q_shape, jnp.int32), jnp.full(q_shape, n, jnp.int32),
            full_steps)
        good = _search_rounds(keys, queries, keep_left_on, lo_w, hi_w, steps)
        return jnp.where(ok, good, full)

    return jax.lax.cond(jnp.all(ok), fast, slow, 0)


@functools.partial(jax.jit)
def lexi_bounds(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex, head=None,
                q_valid=None):
    """(lower, upper) bounds sharing one descent.

    With ``head`` (a ``build_head`` bucket-CDF over k_hi): both bounds
    of query q live in [head[b], head[b+1]] for b = q_hi >> shift —
    exact for ANY key distribution, so the descent runs ~log2(rows per
    bucket) rounds (~7 at 64 rows/bucket) under a dynamic while_loop
    that stops when every lane converges, and the upper bound reuses
    the lower bound as its floor. No tiers, no escapes: a hot 32K-row
    hash run costs its own 15 rounds, not a batch-wide full descent.

    ``q_valid`` (optional) zeroes the spans of padding lanes: their
    0xFFFFFFFF sort keys land in the LAST bucket, which on a
    device-resident index spans the whole sentinel tail (tens of M
    rows after capacity doubling/reserve) — without the mask every
    batch pays ~26 dynamic rounds for lanes whose bounds nobody reads.
    Returned bounds for masked lanes are (0, 0).

    Without ``head``: interpolation-seeded descent (below). The upper
    bound always lies in [lb, n]; for buckets shorter than
    FENCE_STRIDE it lies in [lb, lb + FENCE_STRIDE], so a 10-round
    search over that span replaces the full ~28-round descent. Lanes
    whose span saturates AND whose capped boundary key still compares
    <= the query (hyper-hot keys) are resolved exactly by a full
    upper-bound search under a batch-level lax.cond — typical queries
    skip it entirely (~32% fewer search rounds).
    """
    keys = (k_hi, k_lo, k_ex)
    queries = (q_hi, q_lo, q_ex)
    if head is not None:
        lo0, hi0 = _head_spans(head, q_hi)
        if q_valid is not None:
            lo0 = jnp.where(q_valid, lo0, 0)
            hi0 = jnp.where(q_valid, hi0, 0)
        lb = _search_span_dyn(keys, queries, _lt, lo0, hi0)
        ub = _search_span_dyn(keys, queries, _le_q, lb, hi0)
        return lb, ub
    lb = _binary_search(keys, queries, _lt, q_valid=q_valid)
    n = k_hi.shape[0]
    keep_left = _le_q

    def capped_ub(lo, span, prev_ub, redo):
        """Bounded [lo, lo+span] upper search for lanes in `redo`; flags
        lanes whose bucket may extend past the cap."""
        cap = jnp.minimum(lo + span, n)
        found = _search_rounds(keys, queries, keep_left, lo, cap,
                               span.bit_length() + 1)
        ub = jnp.where(redo, found, prev_ub)
        probe = jnp.minimum(ub, n - 1)
        at_cap = redo & (ub == cap) & (cap < n)
        still_le = ~_lt(q_hi, q_lo, q_ex, jnp.take(k_hi, probe),
                        jnp.take(k_lo, probe), jnp.take(k_ex, probe))
        return ub, at_cap & still_le

    ones = jnp.ones(lb.shape, bool)
    ub_r, suspect = capped_ub(lb, FENCE_STRIDE, jnp.zeros_like(lb), ones)
    if q_valid is not None:
        # a padding lane's sentinel-tail probe always compares <= its
        # all-ones query, so it would drive the tier2/full escalation on
        # every padded batch; its bounds are zeroed below anyway
        suspect = suspect & q_valid

    # hyper-common hashes own 10K-70K rows at production scale and show
    # up in most real query batches, so a straight escape to the full
    # descent fires nearly always there; a 128K middle tier resolves any
    # observed bucket in +8 rounds and keeps the full search for the
    # pathological tail only
    def tier2(_):
        ub2, susp2 = capped_ub(lb, 128 * 1024, ub_r, suspect)
        if q_valid is not None:
            susp2 = susp2 & q_valid

        def full_ub(_):
            ub_f = _binary_search(keys, queries, keep_left, q_valid=q_valid)
            return jnp.where(susp2, ub_f, ub2)

        return jax.lax.cond(jnp.any(susp2), full_ub, lambda _: ub2, 0)

    ub = jax.lax.cond(jnp.any(suspect), tier2, lambda _: ub_r, 0)
    if q_valid is not None:   # same (0, 0) contract as the head path
        lb = jnp.where(q_valid, lb, 0)
        ub = jnp.where(q_valid, ub, 0)
    return lb, ub


class UniqueView(NamedTuple):
    """Serving-side unique-key search table (see ``build_unique_view``).

    Collapses duplicate 80-bit keys into one sorted row each plus a CDF
    of payload-row offsets, so a query's (lb, ub) span costs ONE
    fixed-round descent over the unique table + two CDF takes:

    - the upper bound is free (``ub = cdf[pos + 1]``) — production
      catalogs repeat keys heavily (the 95.3M-row tone build averages
      ~350 rows/hash => 272K unique keys), and ``lexi_bounds`` pays a
      second dynamic descent for it;
    - hot runs (10K-70K duplicate rows) collapse to ONE unique row, so
      they cannot inflate the while_loop trip count — the descent runs
      a STATIC ``steps`` = log2(widest head bucket) rounds measured at
      build time;
    - the searched table shrinks n -> u (1.1 GB -> 3.3 MB at tone-95M).

    The payload columns are untouched; this replaces only the key
    search. Built host-side (``build_unique_view``) because the
    compaction is one numpy pass — the device equivalent is a
    full-size scatter over every index row.
    """

    u_hi: jnp.ndarray   # (u,) uint32 sorted unique hi
    u_lo: jnp.ndarray   # (u,) uint32
    u_ex: jnp.ndarray   # (u,) uint32
    cdf: jnp.ndarray    # (u + 1,) int32 payload-row offsets
    head: jnp.ndarray   # bucket-CDF over u_hi (build_head)


def build_unique_view(key_hi, key_lo, key_ex):
    """(UniqueView, steps) from HOST key columns; None below the head
    threshold (the plain descent already wins on tiny indexes).

    ``steps`` is static: log2(widest head bucket) + 1, measured at
    build time — every query lane's span is one head bucket, so the
    fixed-round descent always converges.
    """
    n = len(key_hi)
    if n < HEAD_MIN_ROWS:
        return None, 0
    hi = np.asarray(key_hi)
    lo = np.asarray(key_lo)
    ex = np.asarray(key_ex)
    new = np.empty(n, bool)
    new[0] = True
    np.logical_or(hi[1:] != hi[:-1],
                  np.logical_or(lo[1:] != lo[:-1], ex[1:] != ex[:-1]),
                  out=new[1:])
    starts = np.flatnonzero(new)
    u = len(starts)
    if u * 2 > n and u > (8 << 20):
        # Near-unique keys at scale: the view would duplicate most of
        # the key columns on device (>128 MB at this size) while the
        # head path is already fast there (no
        # hot runs to inflate its while_loop). Small catalogs keep the
        # view regardless — its fixed-round descent wins and the table
        # costs KBs-MBs. (Measured duplication: tone-95.3M 16.5
        # rows/key, music-27M 4.7, music-1M 1.97.)
        return None, 0
    cdf = np.concatenate([starts, [n]]).astype(np.int32)
    bits = head_bits_for(u)
    head = jax.block_until_ready(build_head(jnp.asarray(hi[starts]),
                                            bits=bits))
    steps = max(1, int(np.max(np.diff(np.asarray(head)))).bit_length() + 1)
    view = UniqueView(jnp.asarray(hi[starts]), jnp.asarray(lo[starts]),
                      jnp.asarray(ex[starts]), jnp.asarray(cdf), head)
    return view, steps


def build_unique_view_spans(spans):
    """Stacked per-span UniqueView for a consolidated spanned store.

    ``spans`` is a list of (hi, lo, ex) HOST key-column tuples — each
    span's valid sorted prefix. Returns (view, steps) where the view's
    arrays carry a leading span axis:

    - ``u_hi/u_lo/u_ex``: (S, u_cap) uint32, sentinel-padded (all-ones
      pad keys only "hit" an all-ones query, which ``q_valid`` masks;
      their cdf span is zero-width anyway);
    - ``cdf``: (S, u_cap + 1) int32, padded entries = the span's valid
      row count (lb == ub for any pad position);
    - ``head``: (S, 2^bits + 1) per-span bucket CDFs over the unique
      keys, one shared resolution;
    - ``steps``: max over spans of log2(widest head bucket) + 1 — the
      static round count every span's descent converges within.

    Query via ``unique_bounds_stacked``. Same near-unique scale gate as
    ``build_unique_view`` (summed across spans): past it the duplicated
    key columns would cost GBs of HBM while hot runs are too mild for
    the view to pay.
    """
    if not spans:
        return None, 0
    total_n = sum(len(s[0]) for s in spans)
    if total_n < HEAD_MIN_ROWS:
        return None, 0
    per = []
    for hi, lo, ex in spans:
        hi = np.asarray(hi)
        lo = np.asarray(lo)
        ex = np.asarray(ex)
        n = len(hi)
        if n == 0:
            per.append((hi, lo, ex, np.zeros(0, np.int64), 0))
            continue
        new = np.empty(n, bool)
        new[0] = True
        np.logical_or(hi[1:] != hi[:-1],
                      np.logical_or(lo[1:] != lo[:-1], ex[1:] != ex[:-1]),
                      out=new[1:])
        starts = np.flatnonzero(new)
        per.append((hi, lo, ex, starts, n))
    u_total = sum(len(p[3]) for p in per)
    if u_total * 2 > total_n and u_total > (8 << 20):
        return None, 0
    u_cap = max(len(p[3]) for p in per)
    if u_cap == 0:
        return None, 0
    bits = head_bits_for(u_cap)
    S = len(per)
    u_hi = np.full((S, u_cap), 0xFFFFFFFF, np.uint32)
    u_lo = np.full((S, u_cap), 0xFFFFFFFF, np.uint32)
    u_ex = np.full((S, u_cap), 0xFFFFFFFF, np.uint32)
    cdf = np.empty((S, u_cap + 1), np.int32)
    heads = []
    steps = 1
    for r, (hi, lo, ex, starts, n) in enumerate(per):
        u = len(starts)
        u_hi[r, :u] = hi[starts]
        u_lo[r, :u] = lo[starts]
        u_ex[r, :u] = ex[starts]
        cdf[r, :u] = starts
        cdf[r, u:] = n
        if u:
            h = jax.block_until_ready(
                build_head(jnp.asarray(u_hi[r, :u]), bits=bits))
            heads.append(np.asarray(h))
            steps = max(steps, int(np.max(np.diff(heads[-1]))).bit_length()
                        + 1)
        else:
            heads.append(np.zeros((1 << bits) + 1, np.int32))
    view = UniqueView(jnp.asarray(u_hi), jnp.asarray(u_lo),
                      jnp.asarray(u_ex), jnp.asarray(cdf),
                      jnp.asarray(np.stack(heads)))
    return view, steps


def unique_bounds_stacked(view: UniqueView, q_hi, q_lo, q_ex, q_valid, *,
                          steps: int):
    """(lb, ub) per (span, lane) from a ``build_unique_view_spans``
    view: ``unique_bounds`` vmapped over the leading span axis, one
    batched gather round per descent step for ALL spans."""
    return jax.vmap(
        lambda a, b, c, d, e: unique_bounds(
            UniqueView(a, b, c, d, e), q_hi, q_lo, q_ex, q_valid,
            steps=steps)
    )(view.u_hi, view.u_lo, view.u_ex, view.cdf, view.head)


def unique_bounds(view: UniqueView, q_hi, q_lo, q_ex, q_valid, *,
                  steps: int):
    """(lb, ub) payload-row spans from a UniqueView.

    Same contract as the head path of ``lexi_bounds``: masked lanes and
    misses return (0, 0) (their spans are zero-width either way — the
    expansion only reads lb where ub > lb).
    """
    if steps <= 0:
        # steps is build-time data (log2 of the widest head bucket); a
        # caller that threads the view but drops the round count would
        # descend zero rounds and silently match nothing.
        raise ValueError(
            "unique_bounds needs the steps returned by build_unique_view")
    u_hi, u_lo, u_ex = view.u_hi, view.u_lo, view.u_ex
    u = u_hi.shape[0]
    lo0, hi0 = _head_spans(view.head, q_hi)
    lo0 = jnp.where(q_valid, lo0, 0)
    hi0 = jnp.where(q_valid, hi0, 0)

    step = _descend_step((u_hi, u_lo, u_ex), (q_hi, q_lo, q_ex), _lt)
    pos, _ = jax.lax.fori_loop(0, steps, lambda _, c: step(*c),
                               (lo0, hi0))
    safe = jnp.minimum(pos, u - 1)
    hit = (pos < u) & q_valid \
        & (jnp.take(u_hi, safe) == q_hi) \
        & (jnp.take(u_lo, safe) == q_lo) \
        & (jnp.take(u_ex, safe) == q_ex)
    lb = jnp.where(hit, jnp.take(view.cdf, safe), 0)
    ub = jnp.where(hit, jnp.take(view.cdf, safe + 1), 0)
    return lb, ub


@functools.partial(jax.jit)
def lexi_lower_bound(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex):
    """First index i with keys[i] >= q (per query lane)."""
    return _binary_search(
        (k_hi, k_lo, k_ex), (q_hi, q_lo, q_ex),
        lambda mh, ml, me, qh, ql, qe: _lt(mh, ml, me, qh, ql, qe),
    )


@functools.partial(jax.jit)
def lexi_upper_bound(k_hi, k_lo, k_ex, q_hi, q_lo, q_ex):
    """First index i with keys[i] > q (per query lane)."""
    return _binary_search(
        (k_hi, k_lo, k_ex), (q_hi, q_lo, q_ex),
        lambda mh, ml, me, qh, ql, qe: ~_lt(qh, ql, qe, mh, ml, me),
    )

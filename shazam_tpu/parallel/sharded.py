"""Sharded catalog operations over a device mesh (shard_map + collectives).

Device-mesh replacement for the reference's distributed story (an external
DB server reached over TCP; thread-pooled SELECT batches in
``recognizer_thread.py:290-298``). Here:

- **Index sharding**: the sorted index splits into contiguous key ranges,
  one per device (see ``mesh.shard_index_arrays``). Every device owns a
  disjoint slice of hash space in its own device memory; a 1M-track
  catalog (~11 G hashes, ~220 GB) spans several hosts' devices this way.
- **Query routing**: query pairs are tiny (a few thousand) so they are
  *replicated* rather than routed — each shard runs the lane-parallel
  binary search against its local range (a key that lives elsewhere just
  yields an empty bucket). No all_to_all needed on this axis.
- **Vote combine**: the per-shard (n_songs, delta_range) vote histograms
  and dedup row counts are ``psum``'d over the device interconnect, then every device ranks
  identically (top_k over the reduced histogram).
- **Ingest**: data parallelism over songs — a batch of padded channels is
  sharded on its leading axis; fingerprinting needs no cross-device
  communication at all (the analog of the reference's process pool,
  ``__init__.py:335-357``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..match.lookup import match_local, rank_votes, RawMatch
from ..ops.fingerprint import fingerprint_batch


@functools.lru_cache(maxsize=128)
def _match_query_program(
    mesh: Mesh, n_index_arrays: int, with_head: bool, *,
    n_songs: int, delta_min: int, delta_range: int, per_shard_cap: int,
    match_capacity: int, topn: int, offset_stride: int,
):
    """Build the jitted key-range match program ONCE per static config.

    The jit cache keys on the wrapped function's identity: rebuilding the
    shard_map closure per call (the old shape of this module) retraced —
    and recompiled — EVERY query.
    The lru_cache pins one jitted callable per (mesh, shapes-independent
    statics); jit then caches per query/index shape as usual.
    """
    axis = mesh.axis_names[0]

    def local_fn(*args):
        idx = args[:n_index_arrays]
        head = args[n_index_arrays][0] if with_head else None
        q = args[n_index_arrays + (1 if with_head else 0):]
        local = tuple(a[0] for a in idx)
        hist, rows_hist, total, n_dropped = match_local(
            local, *q,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=per_shard_cap, offset_stride=offset_stride,
            head=head,
        )
        # key-range sharding concentrates popular hashes: a hot shard can
        # blow its per-shard expansion cap (votes dropped) while the global
        # total stays small — surface that by clamping the reported total
        # above the EFFECTIVE bound (sum of per-shard caps; the 1024/shard
        # floor makes it exceed match_capacity on wide meshes, and a total
        # under it with no local overflow is exact) so align_results and
        # the escalation loop judge against effective_match_capacity
        local_over = (total > per_shard_cap).astype(jnp.int32)
        hist = jax.lax.psum(hist, axis)
        rows_hist = jax.lax.psum(rows_hist, axis)
        total = jax.lax.psum(total, axis)
        # a run excluded on ANY shard adds <= 1 vote to any global bin,
        # so the early-accept bound is the psum of local drop counts
        n_dropped = jax.lax.psum(n_dropped, axis)
        any_over = jax.lax.psum(local_over, axis)
        eff_cap = min(per_shard_cap * mesh.devices.size, 2 ** 31 - 2)
        total = jnp.where(
            any_over > 0, jnp.maximum(total, eff_cap + 1), total
        )
        return rank_votes(hist, rows_hist, total, delta_min=delta_min,
                          topn=topn, n_dropped=n_dropped)

    shard_spec = P(axis, None)
    rep = P()
    n_sharded = n_index_arrays + (1 if with_head else 0)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(shard_spec,) * n_sharded + (rep,) * 6,
        out_specs=RawMatch(rep, rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(fn)


def effective_match_capacity(match_capacity: int, n_dev: int) -> int:
    """Key-range regime's exactness bound: the sum of per-shard caps
    (the 1024 floor makes it exceed ``match_capacity`` past
    match_capacity/1024 devices)."""
    return min(max(match_capacity // n_dev, 1024) * n_dev, 2 ** 31 - 2)


def sharded_match_query(
    mesh: Mesh,
    sharded_index,          # 4 or 5 arrays shaped (n_shards, rows_per_shard)
    q_hi, q_lo, q_ex, q_t, q_valid, q_first,
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    offset_stride: int = 0,
    sharded_head=None,        # (n_shards, 2^bits + 1) per-shard bucket CDFs
) -> RawMatch:
    """Match a replicated query against a key-range-sharded index.

    Judge overflow/escalation against ``effective_match_capacity`` (the
    sum of per-shard caps), not ``match_capacity``: the per-shard floor
    means an exact result's psum'd total can exceed the nominal capacity
    on wide meshes."""
    per_shard_cap = max(match_capacity // mesh.devices.size, 1024)
    fn = _match_query_program(
        mesh, len(sharded_index), sharded_head is not None,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        per_shard_cap=per_shard_cap, match_capacity=match_capacity,
        topn=topn, offset_stride=offset_stride,
    )
    extra = (sharded_head,) if sharded_head is not None else ()
    return fn(*sharded_index, *extra, q_hi, q_lo, q_ex, q_t, q_valid, q_first)


def sharded_ingest_step(
    mesh: Mesh,
    batch: jnp.ndarray,          # (n_songs_batch, padded_len) int16/float32
    n_valid: jnp.ndarray,        # (n_songs_batch,) int32
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
):
    """Data-parallel fingerprinting: batch axis sharded over the mesh.

    Pure dp — XLA partitions the vmapped pipeline with zero collectives;
    we express it with sharding annotations + jit (the idiomatic form for
    embarrassingly parallel compute).

    Pass ``batch`` as int16 for long ingests: it uploads at half the
    bytes and casts to float32 on device.
    """
    axis = mesh.axis_names[0]
    batch = jax.device_put(batch, NamedSharding(mesh, P(axis, None)))
    n_valid = jax.device_put(n_valid, NamedSharding(mesh, P(axis)))
    if batch.dtype != jnp.float32:
        batch = batch.astype(jnp.float32)  # on device, post-upload
    return fingerprint_batch(
        batch, n_valid,
        fs=fs, wsize=wsize, hop=hop, amp_min=amp_min, radius=radius,
        fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
    )


@functools.lru_cache(maxsize=64)
def _apriori_step_program(
    mesh: Mesh, n_index_arrays: int, with_head: bool, *,
    n_songs: int, delta_min: int, delta_range: int, per_shard_cap: int,
    offset_stride: int,
):
    """One apriori ROUND on the key-range mesh: batch match + psum +
    accumulate + the reference's margin signal (top-2 row counts of the
    vote-ranked leaders, ``recognizer_apriori.py:296-310``)."""
    axis = mesh.axis_names[0]

    def local_fn(*args):
        idx = args[:n_index_arrays]
        head = args[n_index_arrays][0] if with_head else None
        q = args[n_index_arrays + (1 if with_head else 0):]
        local = tuple(a[0] for a in idx)
        hist, rows_hist, total, n_dropped = match_local(
            local, *q,
            n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
            match_capacity=per_shard_cap, offset_stride=offset_stride,
            head=head,
        )
        local_over = (total > per_shard_cap).astype(jnp.int32)
        return (jax.lax.psum(hist, axis), jax.lax.psum(rows_hist, axis),
                jax.lax.psum(total, axis), jax.lax.psum(n_dropped, axis),
                jax.lax.psum(local_over, axis))

    shard_spec = P(axis, None)
    rep = P()
    n_sharded = n_index_arrays + (1 if with_head else 0)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(shard_spec,) * n_sharded + (rep,) * 6,
        out_specs=(rep, rep, rep, rep, rep),
        check_vma=False,
    )

    @jax.jit
    def step(sharded_args, q_batch, hist_acc, rows_acc, total_acc,
             nd_acc, over_acc):
        h, r, t, nd, ov = fn(*sharded_args, *q_batch)
        hist_acc = hist_acc + h
        rows_acc = rows_acc + r
        total_acc = total_acc + t
        nd_acc = nd_acc + nd
        over_acc = over_acc + ov
        # margin signal (match.apriori._apriori_step): rank the partial
        # ACCUMULATED votes, read the top-2 songs' dedup row counts
        votes_per_song = jnp.max(hist_acc, axis=1)
        k = min(2, votes_per_song.shape[0])
        _, top_songs = jax.lax.top_k(votes_per_song, k)
        top2 = jnp.take(rows_acc, top_songs)
        if k < 2:
            top2 = jnp.pad(top2, (0, 2 - k))
        return hist_acc, rows_acc, total_acc, nd_acc, over_acc, top2

    return step


def sharded_match_apriori(
    mesh: Mesh,
    sharded_index,
    q,                       # QueryPairs (host)
    *,
    n_songs: int,
    delta_min: int,
    delta_range: int,
    match_capacity: int = 65536,
    topn: int = 2,
    batch_size: int = 1024,
    offset_stride: int = 0,
    sharded_head=None,
):
    """Key-range sharded match with the reference's 2x-leader early exit.

    Query pairs run in ``batch_size`` rounds; each round is one
    shard_map dispatch (local search + expansion on every shard, one
    hist/rows psum) and the host checks the reference margin
    rule between rounds.  An exit skips the remaining rounds' searches
    AND their psums.

    Cost model: a
    full sharded match pays ONE psum of the dense histogram; an
    apriori run pays one PER ROUND, so the mode wins exactly when the
    exit fires early enough that the skipped search/expansion work
    exceeds the extra psums — decisive in-catalog clips on big meshes
    (where per-shard search dominates) and any host-spanning mesh
    (where skipping whole rounds of cross-host psum+search is the
    point).  For never-matching clips it degrades to
    the full match plus (rounds - 1) psums — callers that mostly see
    out-of-catalog audio should keep the full matcher.

    Returns (RawMatch, rounds_used, clamped) — same contract as
    ``match.apriori.match_query_apriori`` (total_rows accumulates
    across rounds; ``clamped`` True iff any round overflowed a shard's
    expansion cap).
    """
    import numpy as np

    per_shard_cap = max(match_capacity // mesh.devices.size, 1024)
    step = _apriori_step_program(
        mesh, len(sharded_index), sharded_head is not None,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        per_shard_cap=per_shard_cap, offset_stride=offset_stride,
    )
    extra = (sharded_head,) if sharded_head is not None else ()
    sharded_args = (*sharded_index, *extra)

    n = max(int(q.n_pairs), 1)
    hist = jnp.zeros((n_songs, delta_range), jnp.int32)
    rows = jnp.zeros(n_songs, jnp.int32)
    total = jnp.int32(0)
    nd = jnp.int32(0)
    over = jnp.int32(0)

    n_batches = max(1, -(-n // batch_size))
    used = 0
    for b in range(n_batches):
        sl = slice(b * batch_size, (b + 1) * batch_size)

        def pad(a):
            chunk = a[sl]
            if len(chunk) < batch_size:
                chunk = np.pad(chunk, (0, batch_size - len(chunk)))
            return jnp.asarray(chunk)

        q_batch = (pad(q.hi), pad(q.lo), pad(q.ex), pad(q.t),
                   pad(q.valid), pad(q.first))
        hist, rows, total, nd, over, top2 = step(
            sharded_args, q_batch, hist, rows, total, nd, over)
        used += 1
        top2_host = jax.device_get(top2)
        if top2_host[0] / 2.0 > top2_host[1] and used < n_batches:
            break

    raw = jax.jit(functools.partial(
        rank_votes, delta_min=delta_min, topn=topn))(
        hist, rows, total, n_dropped=nd)
    clamped = bool(int(jax.device_get(over)) > 0)
    return jax.device_get(raw), used, clamped

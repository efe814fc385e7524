"""Device-resident fingerprint index with on-device sorted merges.

Host ``merge_into`` (store.py) is a linear two-run merge at host memory
bandwidth, plus a full re-upload of the index to HBM after every merge
(``SIA._device_index = None``).  Past ~100M hashes both costs dominate
ingest.  This module keeps the index *on the device* and absorbs each
sorted addition run with a lane-parallel merge that never leaves HBM:

- every base row binary-searches the (small, cache-resident) addition
  for its rank shift; every addition row binary-searches the base;
- one scatter per column places all rows at their merged positions.

Work per merge is O((B + A) log) with zero host<->device index traffic.
The reference pays a SQL INSERT per row (``mysql_database.py:46-59``)
and never merges at all — this is the device-resident equivalent of its
always-online inverted index.

Two absorption strategies:

- ``merge`` / ``merge_device_run`` — scatter merge, queryable after
  every addition.  Its cost is O(base) per call, so it suits
  incremental serving-time additions on modest indexes.
- ``append_run`` + ``finalize`` — memcpy-class tail appends and ONE
  global stable sort on first query/save.  Right for bulk ingest;
  element-identical result (tested).

Compile stability (every new shape is a compile): arrays
live in power-of-two *capacity* buffers padded with all-ones sentinel
rows.  Sentinel keys sort strictly after every real row (real ``ex`` is
16-bit, sentinel ex is 2^32-1), so merges and the query binary search
are correct without masking; the valid count is host-side metadata.
Each merge reuses the base capacity until it fills (scatter drops the
sentinel overflow), so the merge program compiles once per capacity
doubling — O(log N) programs for a whole ingest.

Layouts mirror ``FingerprintIndex.device_arrays()``: 4 columns
(hi, lo, ex, song*stride+offset) when the packed payload fits in
uint32, else 5 (hi, lo, ex, song, offset).  Packed-payload order equals
(song, offset) order, so the full column tuple IS the sort key in both
layouts and the merge is layout-generic.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .store import FingerprintIndex, offset_stride_for

SENTINEL = np.uint32(0xFFFFFFFF)
MIN_CAPACITY = 1 << 16


def _tuple_lt(a: Tuple, b: Tuple):
    """Lexicographic a < b over equal-length tuples of uint32 arrays."""
    out = a[-1] < b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        out = (x < y) | ((x == y) & out)
    return out


def _rank_search(keys: Tuple, queries: Tuple, go_right_on):
    """Per-lane binary search of `queries` into sorted `keys`."""
    n = keys[0].shape[0]
    shape = queries[0].shape
    lo = jnp.zeros(shape, jnp.int32)
    hi = jnp.full(shape, n, jnp.int32)
    steps = max(1, (n - 1).bit_length() if n > 1 else 1) + 1

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        mids = tuple(jnp.take(k, mid) for k in keys)
        right = go_right_on(mids, queries) & (lo < hi)
        return (
            jnp.where(right, mid + 1, lo),
            jnp.where(right | (lo >= hi), hi, mid),
        )

    lo, _hi = lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def _lower_rank(keys, queries):
    """#elements of `keys` strictly below each query (lower bound)."""
    return _rank_search(keys, queries, lambda m, q: _tuple_lt(m, q))


def _upper_rank(keys, queries):
    """#elements of `keys` at or below each query (upper bound)."""
    return _rank_search(keys, queries, lambda m, q: ~_tuple_lt(q, m))


@jax.jit
def merge_runs(base_cols: Tuple, add_cols: Tuple) -> Tuple:
    """Stable merge of two sorted runs on the full column tuple.

    Output length = len(base); rows whose merged position overflows the
    base capacity are dropped (by construction only sentinel rows can,
    while n_valid_total <= capacity).  Equal keys keep base rows first —
    element-identical to ``merge_into`` on the valid prefix.
    """
    nb = base_cols[0].shape[0]
    na = add_cols[0].shape[0]
    pos_b = jnp.arange(nb, dtype=jnp.int32) + _lower_rank(add_cols, base_cols)
    pos_a = jnp.arange(na, dtype=jnp.int32) + _upper_rank(base_cols, add_cols)
    out = []
    for cb, ca in zip(base_cols, add_cols):
        o = jnp.full(nb, SENTINEL, cb.dtype)
        o = o.at[pos_b].set(cb, mode="drop", unique_indices=True)
        o = o.at[pos_a].set(ca, mode="drop", unique_indices=True)
        out.append(o)
    return tuple(out)


@jax.jit
def _grow(cols: Tuple) -> Tuple:
    """Double capacity: append a sentinel tail of equal length."""
    return tuple(
        jnp.concatenate([c, jnp.full(c.shape[0], SENTINEL, c.dtype)])
        for c in cols
    )


@functools.partial(jax.jit, static_argnames=("old_stride", "new_stride"))
def _repack(cols: Tuple, n_valid, old_stride: int, new_stride: int) -> Tuple:
    """Rewrite packed payload p = sid*old + off as sid*new + off."""
    hi, lo, ex, p = cols
    sid = p // np.uint32(old_stride)
    off = p & np.uint32(old_stride - 1)
    newp = sid * np.uint32(new_stride) + off
    mask = jnp.arange(p.shape[0]) < n_valid
    return hi, lo, ex, jnp.where(mask, newp, SENTINEL)


@functools.partial(jax.jit, static_argnames=("old_stride",))
def _unpack(cols: Tuple, n_valid, old_stride: int) -> Tuple:
    """Packed 4-column layout -> unpacked 5-column layout."""
    hi, lo, ex, p = cols
    mask = jnp.arange(p.shape[0]) < n_valid
    sid = jnp.where(mask, p // np.uint32(old_stride), SENTINEL)
    off = jnp.where(mask, p & np.uint32(old_stride - 1), SENTINEL)
    return hi, lo, ex, sid, off


@functools.partial(jax.jit, static_argnames=("length",))
def _fetch_chunk(col, start, length: int):
    return jax.lax.dynamic_slice_in_dim(col, start, length)


def _capacity(n: int) -> int:
    c = MIN_CAPACITY
    while c < n:
        c <<= 1
    return c


_DOWNLOAD_CHUNK = 1 << 24  # rows (64 MB) per device->host transfer


def _download_prefix(col, n_valid: int) -> np.ndarray:
    """Fetch a column's valid prefix in bounded transfers.

    One jitted dynamic_slice per column shape keeps every transfer at
    64 MB (bounded host staging for multi-GB columns) with O(log)
    compiled programs.
    """
    n = int(n_valid)
    chunk = _DOWNLOAD_CHUNK
    if n <= chunk:
        return np.asarray(col[:n] if n < col.shape[0] else col)
    parts = []
    start = 0
    while start < n:
        s = min(start, n - chunk)   # last chunk backs up to cover n
        part = np.asarray(_fetch_chunk(col, jnp.int32(s), chunk))
        parts.append(part[start - s:])
        start = s + chunk
    return np.concatenate(parts)[:n]


def _stride_for(max_offset: int, n_songs: int) -> int:
    """Packing stride — delegates to the single-sourced rule so the
    device layout can never drift from ``FingerprintIndex.offset_stride``."""
    return offset_stride_for(max_offset, n_songs)


def pack_padded_cols(hi, lo, ex, sid, off, *, stride: int, cap: int) -> Tuple:
    """THE payload pack + sentinel pad rule for host->device uploads.

    ``sid * stride + off`` in one uint32 column when ``stride`` (split
    sid/off columns otherwise), every column padded with SENTINEL to
    ``cap`` rows. Single-sourced for the same reason as ``_stride_for``:
    every uploader (DeviceIndex.from_host/merge, SpannedDeviceStore.
    from_host, FingerprintIndex.device_arrays) must agree or payloads
    decode with the wrong divisor.
    """
    n = len(hi)
    pad = cap - n

    def up(a):
        a = a.astype(np.uint32)
        if pad:
            a = np.concatenate([a, np.full(pad, SENTINEL, np.uint32)])
        return jnp.asarray(a)

    if stride:
        packed = sid.astype(np.uint32) * np.uint32(stride) \
            + off.astype(np.uint32)
        return (up(hi), up(lo), up(ex), up(packed))
    return (up(hi), up(lo), up(ex), up(sid), up(off))


class DeviceIndex:
    """HBM-resident sorted index absorbing additions on the device.

    The authoritative store during device-resident ingest; ``to_host``
    materializes a ``FingerprintIndex`` for persistence/stats.  Query
    code consumes ``query_cols()`` + ``stride`` directly — the column
    tuple already matches ``FingerprintIndex.device_arrays()`` (sentinel
    tail rows are inert: no real 80-bit key compares equal to them).
    """

    def __init__(self, cols: Tuple, n_valid: int, n_songs: int,
                 max_offset: int, stride: int):
        self.cols = cols
        self.n_valid = int(n_valid)
        self.n_songs = int(n_songs)
        self.max_offset = int(max_offset)
        self.stride = int(stride)  # 0 => 5-column unpacked layout
        self._unsorted = False     # deferred-sort appends pending

    # ---- construction -------------------------------------------------
    @classmethod
    def from_host(cls, ix: FingerprintIndex,
                  reserve: int = 0) -> "DeviceIndex":
        """Upload a host index; ``reserve`` preallocates capacity so a
        large ingest compiles ONE merge program instead of one per
        capacity doubling."""
        cap = _capacity(max(ix.n_hashes, reserve, 1))
        stride = ix.offset_stride
        cols = pack_padded_cols(ix.key_hi, ix.key_lo, ix.key_ex,
                                ix.song_id, ix.offset,
                                stride=stride, cap=cap)
        return cls(cols, ix.n_hashes, ix.n_songs, ix.max_offset, stride)

    # ---- merge --------------------------------------------------------
    def _ensure_layout(self, n_songs: int, max_offset: int) -> None:
        """Repack/unpack the base if catalog growth changes the stride."""
        new_stride = _stride_for(max_offset, n_songs)
        if self.stride == new_stride:
            return
        if self.stride and new_stride:
            self.cols = _repack(self.cols, jnp.int32(self.n_valid),
                                old_stride=self.stride,
                                new_stride=new_stride)
        elif self.stride and not new_stride:
            self.cols = _unpack(self.cols, jnp.int32(self.n_valid),
                                old_stride=self.stride)
        # (unpacked -> packed never happens: strides only grow)
        self.stride = new_stride

    def merge(self, addition: FingerprintIndex) -> None:
        """Absorb a sorted addition run entirely on the device."""
        if addition.n_hashes == 0:
            return
        self.finalize()
        n_songs = max(self.n_songs, addition.n_songs)
        max_off = max(self.max_offset, addition.max_offset)
        self._ensure_layout(n_songs, max_off)
        new_valid = self.n_valid + addition.n_hashes
        while self.cols[0].shape[0] < new_valid:
            self.cols = _grow(self.cols)

        add_cols = pack_padded_cols(
            addition.key_hi, addition.key_lo, addition.key_ex,
            addition.song_id, addition.offset,
            stride=self.stride, cap=_capacity(addition.n_hashes))
        self.cols = merge_runs(self.cols, add_cols)
        self.n_valid = new_valid
        self.n_songs = n_songs
        self.max_offset = max_off

    def merge_device_run(self, add_cols: Tuple, n_add: int,
                         n_songs: int, max_offset: int) -> None:
        """Absorb an addition that already lives on the device.

        ``add_cols`` must be a sentinel-padded sorted run in this
        index's CURRENT layout — callers run ``_ensure_layout`` first
        and build payloads with ``self.stride`` (index/devingest.py
        does).  No host<->device traffic at all.
        """
        if n_add == 0:
            return
        if self.stride == 0 or len(add_cols) != len(self.cols):
            raise ValueError(
                "device-run merge requires the packed 4-column layout; "
                "use the host ingest path for unpacked catalogs"
            )
        self.finalize()
        new_valid = self.n_valid + n_add
        while self.cols[0].shape[0] < new_valid:
            self.cols = _grow(self.cols)
        self.cols = merge_runs(self.cols, add_cols)
        self.n_valid = new_valid
        self.n_songs = max(self.n_songs, n_songs)
        self.max_offset = max(self.max_offset, max_offset)

    def append_run(self, add_cols: Tuple, n_add: int,
                   n_songs: int, max_offset: int) -> None:
        """Deferred-sort ingest: write the run at the tail, sort later.

        The lane-parallel scatter merge costs O(base) per call —
        pathological for bulk ingest.  Appends are memcpy-class
        dynamic-slice writes; one global stable sort at
        :meth:`finalize` yields
        the identical index (equal full-column rows are interchangeable,
        so the merge tie rule is unobservable).  Layout rules match
        ``merge_device_run``.
        """
        if n_add == 0:
            return
        if self.stride == 0 or len(add_cols) != len(self.cols):
            raise ValueError(
                "device-run append requires the packed 4-column layout; "
                "use the host ingest path for unpacked catalogs"
            )
        # slice the sentinel-padded run tight before sizing (same rule
        # as the spanned variant): growing capacity to fit PADDING would
        # double the buffer — and recompile every append/sort shape —
        # right at the reserve boundary
        # of a bulk ingest, for rows that are all sentinels
        run_len = min(_run_pow2(n_add), add_cols[0].shape[0])
        if run_len < add_cols[0].shape[0]:
            add_cols = tuple(c[:run_len] for c in add_cols)
        add_len = add_cols[0].shape[0]
        while self.cols[0].shape[0] < self.n_valid + add_len:
            self.cols = _grow(self.cols)  # full padded run must fit
        start = jnp.int32(self.n_valid)
        self.cols = tuple(
            jax.lax.dynamic_update_slice(c, a, (start,))
            for c, a in zip(self.cols, add_cols)
        )
        self.n_valid += n_add
        self.n_songs = max(self.n_songs, n_songs)
        self.max_offset = max(self.max_offset, max_offset)
        self._unsorted = True

    def finalize(self) -> None:
        """Sort pending appended runs into place (no-op when sorted).

        The tail beyond each appended run's valid rows is sentinel, so
        the single stable sort moves every real row into global order
        and all padding to the end — element-identical to a sequence of
        scatter merges.
        """
        if self._unsorted:
            self.cols = lax.sort(self.cols, num_keys=len(self.cols))
            self._unsorted = False

    def _download(self, col) -> np.ndarray:
        return _download_prefix(col, self.n_valid)

    # ---- consumption --------------------------------------------------
    def query_cols(self) -> Tuple:
        """Device arrays in the shape ``match_query`` expects."""
        self.finalize()
        return self.cols

    def to_host(self) -> FingerprintIndex:
        self.finalize()
        cols = [self._download(c) for c in self.cols]
        if self.stride:
            hi, lo, ex, p = cols
            sid = (p // np.uint32(self.stride)).astype(np.uint32)
            off = (p & np.uint32(self.stride - 1)).astype(np.uint32)
        else:
            hi, lo, ex, sid, off = cols
        return FingerprintIndex(hi, lo, ex, sid, off,
                                n_songs=self.n_songs,
                                max_offset=self.max_offset)


@functools.partial(jax.jit, donate_argnums=(0,))
def _stack_row(big, col, i):
    """Write one span column into row i of the stacked buffer in place
    (donation reuses big's allocation — consolidation never holds more
    than the catalog + ONE stacked column)."""
    return jax.lax.dynamic_update_slice(big, col.reshape(1, -1), (i, 0))


def _run_pow2(n: int) -> int:
    """Smallest power-of-two >= n (floor 1024) — bounded program count
    for sliced addition runs."""
    c = 1024
    while c < n:
        c <<= 1
    return c


class SpannedDeviceStore:
    """HBM index as multiple bounded sorted spans: beyond-one-sort scale.

    A single ``DeviceIndex`` doubles its capacity buffer and re-sorts the
    WHOLE index at :meth:`finalize` — at the reference's largest recorded
    deployment (436,682,654 hashes, ``fingerprints_queries.sql:3``) that
    is a multi-GB allocation sorted twice over (in+out), which on a
    16 GB device does not fit beside the fingerprint pipeline.  This
    store caps every span at a fixed
    ``span_rows`` capacity: ingest appends into the ACTIVE (last) span,
    seals it with one bounded sort when the next run would not fit, and
    opens a fresh span.  No device program ever touches more than one
    span, so sort cost, scratch memory and program shapes are all
    O(span_rows) regardless of catalog size.

    Queries search every span (each is an independent sorted run with
    its own bucket-CDF head) and merge the vote streams before ranking —
    ``match.lookup.match_query_sparse_spanned`` — the device analog of the
    reference's multi-shard knob it never turned on
    (``elastic_database.py:42,80``, number_of_shards pinned to 1).

    Shares the ``DeviceIndex`` ingest surface consumed by ``api.SIA``
    (stride / n_valid / n_songs / max_offset, ``_ensure_layout``,
    ``append_run``, ``merge_device_run``, ``merge``, ``finalize``,
    ``query_cols``, ``to_host``).  Packed 4-column layout only: at the
    scale that needs spans, an unpacked catalog should use the by-song
    sharded regime instead.
    """

    is_spanned = True

    def __init__(self, span_rows: int, n_songs: int = 0,
                 max_offset: int = 0, stride: int = 1):
        if span_rows < MIN_CAPACITY // 16:
            raise ValueError(f"span_rows {span_rows} is below the "
                             f"minimum {MIN_CAPACITY // 16}")
        if stride == 0:
            raise ValueError("SpannedDeviceStore requires the packed "
                             "4-column layout (stride > 0)")
        self.span_rows = int(span_rows)
        self.n_songs = int(n_songs)
        self.max_offset = int(max_offset)
        self.stride = int(stride)
        self.spans: list = [self._new_span()]
        self._stacked = None          # consolidate() serving layout
        self._stacked_valids: list = []
        # stacked per-span unique-key view (build_unique_view_spans),
        # built where host key rows pass through (load(stacked=True),
        # from_host); None = the matchers use the bucket-CDF heads
        self._uview = None
        self._usteps = 0

    # ---- construction -------------------------------------------------
    @classmethod
    def from_host(cls, ix: FingerprintIndex, span_rows: int,
                  reserve: int = 0) -> "SpannedDeviceStore":
        """Upload a host index split into contiguous sorted spans.

        ``reserve`` is accepted for ``DeviceIndex.from_host`` parity but
        unused — span capacity is fixed, so every ingest already compiles
        a bounded set of programs.
        """
        stride = ix.offset_stride
        if stride == 0 and ix.n_hashes > 0:
            raise ValueError(
                "SpannedDeviceStore requires the packed payload layout; "
                "use DeviceIndex / the by-song sharded regime instead")
        store = cls(span_rows, ix.n_songs, ix.max_offset,
                    stride if stride else 1)
        key_rows = []
        for start in range(0, ix.n_hashes, span_rows):
            n = min(span_rows, ix.n_hashes - start)
            sl = slice(start, start + n)
            cols = pack_padded_cols(
                ix.key_hi[sl], ix.key_lo[sl], ix.key_ex[sl],
                ix.song_id[sl], ix.offset[sl],
                stride=stride, cap=span_rows)
            span = DeviceIndex(cols, n, ix.n_songs, ix.max_offset, stride)
            key_rows.append((ix.key_hi[sl], ix.key_lo[sl], ix.key_ex[sl]))
            if store.spans[-1].n_valid == 0:
                store.spans[-1] = span
            else:
                store.spans.append(span)
        # host key columns are in hand: pre-build the stacked unique-key
        # view so consolidate() can serve through it (the per-span tuple
        # layout ignores it)
        from .search import build_unique_view_spans

        store._uview, store._usteps = build_unique_view_spans(key_rows)
        return store

    # ---- shared-surface properties ------------------------------------
    @property
    def n_valid(self) -> int:
        return sum(self._stacked_valids) + sum(s.n_valid for s in self.spans)

    @property
    def is_stacked(self) -> bool:
        return self._stacked is not None

    @property
    def uview(self):
        """(stacked UniqueView, steps) for the CONSOLIDATED layout, or
        (None, 0). Only meaningful once stacked — the per-span tuple
        matchers ignore it, and ingest invalidates it."""
        if self.is_stacked and self._uview is not None:
            return self._uview, self._usteps
        return None, 0

    @property
    def active(self) -> DeviceIndex:
        return self.spans[-1]

    def _new_span(self) -> DeviceIndex:
        cols = tuple(jnp.full(self.span_rows, SENTINEL, jnp.uint32)
                     for _ in range(4))
        return DeviceIndex(cols, 0, self.n_songs, self.max_offset,
                           self.stride)

    def _seal_active(self) -> None:
        """Sort the active span into final order and open a fresh one."""
        self.active.finalize()
        self.spans.append(self._new_span())

    def _ensure_layout(self, n_songs: int, max_offset: int) -> None:
        """Repack EVERY span if catalog growth changes the stride —
        queries assume one stride across spans."""
        new_stride = _stride_for(max_offset, n_songs)
        if new_stride == 0:
            raise ValueError(
                f"catalog ({n_songs} songs x offset {max_offset}) exceeds "
                "the packed uint32 payload; spanned device residency "
                "cannot hold it — use the by-song sharded regime")
        if self.is_stacked and new_stride != self.stride:
            raise ValueError(
                "store is consolidated; a layout change (stride "
                f"{self.stride} -> {new_stride}) cannot be applied to "
                "the stacked arrays")
        for s in self.spans:
            s._ensure_layout(n_songs, max_offset)
            s.n_songs = max(s.n_songs, n_songs)
            s.max_offset = max(s.max_offset, max_offset)
        self.stride = new_stride
        self.n_songs = max(self.n_songs, n_songs)
        self.max_offset = max(self.max_offset, max_offset)

    # ---- ingest --------------------------------------------------------
    def _fit_or_roll(self, need_rows: int) -> DeviceIndex:
        if self.is_stacked:
            raise ValueError(
                "store is consolidated (stacked serving layout); "
                "re-opening for ingest is not supported — keep the "
                "per-span layout while the catalog is still growing")
        if need_rows > self.span_rows:
            raise ValueError(
                f"one addition run ({need_rows} rows incl. padding) "
                f"exceeds span_rows {self.span_rows}; raise span_rows or "
                "split the batch")
        # any ingest invalidates a pre-built unique-key view (from_host
        # builds one eagerly; the view describes frozen span contents)
        self._uview, self._usteps = None, 0
        if self.active.n_valid + need_rows > self.span_rows:
            self._seal_active()
        return self.active

    def append_run(self, add_cols: Tuple, n_add: int,
                   n_songs: int, max_offset: int) -> None:
        """Deferred-sort ingest into the active span (see
        ``DeviceIndex.append_run``); rolls to a fresh span when the run
        would not fit, sealing the full one with a bounded sort."""
        if n_add == 0:
            return
        self._ensure_layout(max(self.n_songs, n_songs),
                            max(self.max_offset, max_offset))
        # slice the sentinel-padded run tight: less HBM written per
        # append and less span capacity consumed (O(log) slice shapes)
        run_len = min(_run_pow2(n_add), add_cols[0].shape[0])
        if run_len < add_cols[0].shape[0]:
            add_cols = tuple(c[:run_len] for c in add_cols)
        span = self._fit_or_roll(run_len)
        span.append_run(add_cols, n_add, self.n_songs, self.max_offset)
        self.n_songs = span.n_songs
        self.max_offset = span.max_offset

    def merge_device_run(self, add_cols: Tuple, n_add: int,
                         n_songs: int, max_offset: int) -> None:
        """Scatter-merge a device run into the active span (bounded at
        span_rows, so the scatter's cost is bounded by the span)."""
        if n_add == 0:
            return
        self._ensure_layout(max(self.n_songs, n_songs),
                            max(self.max_offset, max_offset))
        run_len = min(_run_pow2(n_add), add_cols[0].shape[0])
        if run_len < add_cols[0].shape[0]:
            add_cols = tuple(c[:run_len] for c in add_cols)
        # scatter-merge keeps base length: only the n_add real rows
        # consume span capacity
        span = self._fit_or_roll(n_add)
        span.merge_device_run(add_cols, n_add, self.n_songs,
                              self.max_offset)
        self.n_songs = span.n_songs
        self.max_offset = span.max_offset

    def merge(self, addition: FingerprintIndex) -> None:
        """Absorb a host-side sorted addition (chunked to span bounds)."""
        if addition.n_hashes == 0:
            return
        self._ensure_layout(max(self.n_songs, addition.n_songs),
                            max(self.max_offset, addition.max_offset))
        chunk = self.span_rows // 2
        for start in range(0, addition.n_hashes, chunk):
            sl = slice(start, min(start + chunk, addition.n_hashes))
            piece = FingerprintIndex(
                addition.key_hi[sl], addition.key_lo[sl],
                addition.key_ex[sl], addition.song_id[sl],
                addition.offset[sl], n_songs=self.n_songs,
                max_offset=self.max_offset)
            # only real rows land in the span (merge_runs keeps base
            # length; the padded upload is search-side), so fit on
            # n_hashes, not the padded capacity
            span = self._fit_or_roll(piece.n_hashes)
            span.merge(piece)
            self.n_songs = span.n_songs
            self.max_offset = span.max_offset

    # ---- consumption ---------------------------------------------------
    def finalize(self) -> None:
        for s in self.spans:
            s.finalize()

    # ---- persistence ----------------------------------------------------
    _COL_NAMES = ("hi", "lo", "ex", "pp")

    def _live_span_views(self):
        """(cols, n_valid) per non-empty span, per-span or stacked."""
        self.finalize()
        if self.is_stacked:
            return [(tuple(c[i] for c in self._stacked), nv)
                    for i, nv in enumerate(self._stacked_valids) if nv > 0]
        return [(s.cols, s.n_valid) for s in self.spans if s.n_valid > 0]

    def save(self, path: str) -> None:
        """Persist span-wise: each span's valid prefix, no global sort.

        The flat path (``SIA.index.save`` via ``to_host``) concatenates
        and re-sorts the whole catalog on the host — minutes of lexsort
        plus 2x peak RAM at the 436M-hash scale this store exists for.
        The spanned format downloads each span's valid prefix (bounded
        64 MB transfers) and keeps the span structure, so :meth:`load`
        re-uploads with zero sorting on either side.  Uncompressed npz:
        sorted uint32 key columns barely deflate and zlib would dominate
        the wall time at production scale.
        """
        payload = {"spanned_meta": np.array(
            [self.span_rows, self.stride, self.n_songs, self.max_offset],
            np.int64)}
        for i, (cols, nv) in enumerate(self._live_span_views()):
            for name, col in zip(self._COL_NAMES, cols):
                payload[f"s{i:05d}_{name}"] = _download_prefix(col, nv)
        from ..utils.persist import atomic_savez

        atomic_savez(path, compress=False, **payload)

    @classmethod
    def load(cls, path: str, span_rows: int = 0,
             stacked: bool = False) -> "SpannedDeviceStore":
        """Rebuild a store from :meth:`save` output — upload only, no
        sorting.  ``span_rows`` (default: as saved) may differ: every
        saved span is itself sorted, so re-slicing it into smaller spans
        preserves the per-span sorted invariant.

        ``stacked=True`` builds the :meth:`consolidate` serving layout
        DIRECTLY from the snapshot: same upload bytes, but the per-span
        source columns never exist on device, so peak HBM is the stacked
        layout alone.  ``consolidate()`` of a live store needs catalog +
        one extra column + copy transients, which at the 436M-hash
        scale exceeds a 16 GB device; loading stacked is the way to
        serve such snapshots where memory is that tight.  A stacked store is
        terminal for ingest, like any consolidated store."""
        with np.load(path) as z:
            meta = z["spanned_meta"]
            saved_rows, stride, n_songs, max_off = (int(x) for x in meta)
            span_rows = span_rows or saved_rows
            store = cls(span_rows, n_songs, max_off, max(stride, 1))
            store.spans = []
            # (saved span, start, rows) per device span — each saved
            # span re-sliced independently (concatenations of two saved
            # spans are not sorted)
            rows = []
            i = 0
            while f"s{i:05d}_hi" in z:
                n = int(z[f"s{i:05d}_hi"].shape[0])
                for start in range(0, n, span_rows):
                    rows.append((i, start, min(span_rows, n - start)))
                i += 1
            if stacked and rows:
                stacked_cols = []
                key_rows = []  # (hi, lo, ex) host prefixes per span
                for name in cls._COL_NAMES:
                    big = np.full((len(rows), span_rows), SENTINEL,
                                  np.uint32)
                    for r, (i, start, m) in enumerate(rows):
                        big[r, :m] = z[f"s{i:05d}_{name}"][start:start + m]
                    stacked_cols.append(jnp.asarray(big))
                    if name in ("hi", "lo", "ex"):
                        key_rows.append([big[r, :m] for r, (_, _, m)
                                         in enumerate(rows)])
                jax.block_until_ready(stacked_cols[-1])
                store._stacked = tuple(stacked_cols)
                store._stacked_valids = [m for (_, _, m) in rows]
                # the host key rows are in hand exactly here — build the
                # stacked unique-key view the serving matchers prefer
                # (per-span fixed-round descents, free upper bounds)
                from .search import build_unique_view_spans

                store._uview, store._usteps = build_unique_view_spans(
                    list(zip(*key_rows)))
                return store
            last_i, cols_np = -1, None
            for i, start, m in rows:
                if i != last_i:   # one npz read per saved span + column
                    cols_np = [np.asarray(z[f"s{i:05d}_{n}"])
                               for n in cls._COL_NAMES]
                    last_i = i
                pad = span_rows - m
                cols = tuple(
                    jnp.asarray(np.concatenate(
                        [c[start:start + m],
                         np.full(pad, SENTINEL, np.uint32)]))
                    for c in cols_np)
                store.spans.append(DeviceIndex(
                    cols, m, n_songs, max_off, store.stride))
            if not store.spans:
                store.spans = [store._new_span()]
            return store

    @classmethod
    def load_flat(cls, path: str) -> FingerprintIndex:
        """Load :meth:`save` output into ONE sorted host index without
        touching the device (for non-device-resident consumers)."""
        with np.load(path) as z:
            meta = z["spanned_meta"]
            stride, n_songs, max_off = (int(x) for x in meta[1:])
            parts = {n: [] for n in cls._COL_NAMES}
            i = 0
            while f"s{i:05d}_hi" in z:
                for n in cls._COL_NAMES:
                    parts[n].append(np.asarray(z[f"s{i:05d}_{n}"]))
                i += 1
        cat = {n: (np.concatenate(p) if p else np.zeros(0, np.uint32))
               for n, p in parts.items()}
        sid = (cat["pp"] // np.uint32(max(stride, 1))).astype(np.uint32)
        off = (cat["pp"] & np.uint32(max(stride, 1) - 1)).astype(np.uint32)
        order = np.lexsort((off, sid, cat["ex"], cat["lo"], cat["hi"]))
        return FingerprintIndex(
            cat["hi"][order], cat["lo"][order], cat["ex"][order],
            sid[order], off[order], n_songs=n_songs, max_offset=max_off)

    def consolidate(self) -> None:
        """Stack the spans into (n_spans, span_rows) serving arrays.

        The per-span tuple layout searches spans in an unrolled loop —
        n_spans serialized descent/expansion rounds per query; the
        stacked layout lets the matcher vmap over the span axis, issuing
        every span's gathers in one batched round.  Column-by-column
        stacking keeps peak HBM at resident + ONE stacked column; each
        source column is released once its stacked column has synced
        (a transient fault therefore leaves the per-span layout whole).
        Terminal
        for ingest: further appends/merges raise (consolidate a copy of
        a growing catalog via ``to_host`` -> ``from_host`` instead).
        """
        if self.is_stacked:
            return
        self.finalize()
        live = [s for s in self.spans if s.n_valid > 0] or [self.spans[-1]]
        stacked = []
        oom = False
        try:
            self._consolidate_columns(live, stacked)
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e):
                self._restore_spans(live, stacked)
                raise
            oom = True
        except BaseException:
            self._restore_spans(live, stacked)
            raise
        if oom:
            # HBM can't fit sources + a stacked column + copy transients
            # (436M hashes on a 16 GB device). Stage the
            # remaining columns through the host: sources release as
            # they download, so the device never holds more than the
            # catalog itself. Run OUTSIDE the except block: the active
            # traceback would pin _consolidate_columns' frame — and the
            # failed multi-GB stacked column in it — alive for the whole
            # host-staged pass, re-creating the very pressure that
            # OOMed. (Serving a snapshot should prefer load(stacked=True),
            # which skips the download half too.)
            try:
                self._consolidate_via_host(live, stacked)
            except BaseException:
                self._restore_spans(live, stacked)
                raise
        self._stacked = tuple(stacked)
        self._stacked_valids = [s.n_valid for s in live]
        self.spans = []

    def _restore_spans(self, live, stacked) -> None:
        """Re-materialize released source columns from their stacked
        copies (stacked row i IS span i's column, sentinel-padded) so a
        fault leaves the per-span layout whole, as the contract above
        promises — without this, spans hold None for columns 0..c-1 and
        every later operation crashes on them.  Each stacked column is
        downloaded WHOLE and freed before its rows re-upload: per-row
        device slices would allocate into the very OOM that may have
        gotten us here."""
        for c_done in range(len(stacked)):
            if not any(s.cols[c_done] is None for s in live):
                continue
            big_np = np.asarray(stacked[c_done])
            stacked[c_done] = None            # free before re-uploading
            for i, s in enumerate(live):
                if s.cols[c_done] is None:
                    cols = list(s.cols)
                    cols[c_done] = jnp.asarray(big_np[i])
                    s.cols = tuple(cols)

    def _consolidate_via_host(self, live, stacked) -> None:
        """Finish consolidation with host staging: download each span's
        column (releasing its device buffer), then upload the stacked
        column.  Peak device memory never exceeds the catalog itself;
        the cost is one host round trip of the remaining columns."""
        for c in range(len(stacked), len(live[0].cols)):
            host_rows = []
            try:
                for s in live:
                    host_rows.append(np.asarray(s.cols[c]))   # download
                    cols = list(s.cols)
                    cols[c] = None                 # release the source
                    s.cols = tuple(cols)
                big = jnp.asarray(np.stack(host_rows))
                big.block_until_ready()
            except BaseException:
                # re-upload what this column released (best effort —
                # the data is safe in host_rows)
                for s, row in zip(live, host_rows):
                    if s.cols[c] is None:
                        cols = list(s.cols)
                        cols[c] = jnp.asarray(row)
                        s.cols = tuple(cols)
                raise
            stacked.append(big)

    def _consolidate_columns(self, live, stacked) -> None:
        for c in range(len(live[0].cols)):
            # allocate the (S, span_rows) column FIRST: if HBM cannot fit
            # it (resident catalog + one stacked column ~= 1.25x the
            # catalog), the failure happens before any source buffer has
            # been dropped and the per-span layout stays fully usable.
            # Rows then land via donated in-place updates and each span's
            # source column is released immediately — peak demand never
            # exceeds that first allocation.
            big = jnp.full((len(live), self.span_rows), SENTINEL,
                           jnp.uint32)
            big.block_until_ready()
            for i, s in enumerate(live):
                big = _stack_row(big, s.cols[c], jnp.int32(i))
            # sync BEFORE releasing the sources: transient device faults
            # surface at the next sync, so releasing per-dispatch would
            # leave spans with None columns when a mid-column dispatch
            # failed.  Peak HBM is identical either way — it occurs at
            # the `big` allocation above, when every source column is
            # still live.
            big.block_until_ready()
            for s in live:
                cols = list(s.cols)
                cols[c] = None                # release the source
                s.cols = tuple(cols)
            stacked.append(big)

    def query_cols(self):
        """Per-span column tuples, or the stacked 4-tuple once
        consolidated (both accepted by ``match_query_sparse_spanned``)."""
        if self.is_stacked:
            return self._stacked
        self.finalize()
        live = tuple(s.cols for s in self.spans if s.n_valid > 0)
        # an empty store still needs one searchable span
        return live if live else (self.spans[-1].cols,)

    def to_host(self) -> FingerprintIndex:
        """Materialize ONE globally sorted host index (persistence/stats).

        Spans are each sorted; the host-side lexsort restores global
        order (equal full-column rows are interchangeable, so this is
        element-identical to a single-store build).
        """
        self.finalize()
        if self.is_stacked:
            parts = [
                DeviceIndex(tuple(c[i] for c in self._stacked), nv,
                            self.n_songs, self.max_offset,
                            self.stride).to_host()
                for i, nv in enumerate(self._stacked_valids) if nv > 0
            ]
        else:
            parts = [s.to_host() for s in self.spans if s.n_valid > 0]
        if not parts:
            return FingerprintIndex(
                *(np.zeros(0, np.uint32) for _ in range(5)),
                n_songs=self.n_songs, max_offset=self.max_offset)
        cat = [np.concatenate([getattr(p, f) for p in parts])
               for f in ("key_hi", "key_lo", "key_ex", "song_id", "offset")]
        order = np.lexsort((cat[4], cat[3], cat[2], cat[1], cat[0]))
        return FingerprintIndex(*(a[order] for a in cat),
                                n_songs=self.n_songs,
                                max_offset=self.max_offset)


def is_spanned_file(path: str) -> bool:
    """True when ``path`` is a SpannedDeviceStore.save npz (vs the flat
    ``FingerprintIndex.save`` format)."""
    try:
        with np.load(path) as z:
            return "spanned_meta" in z
    except Exception:
        return False

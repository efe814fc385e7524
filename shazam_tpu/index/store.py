"""HBM-resident fingerprint index: sorted 80-bit keys + payload arrays.

Device-resident replacement for the reference's external inverted index (the
MySQL ``fingerprints`` table, ``mysql_database.py:46-59``: BINARY(10) hash
keyed rows of (song_id, offset)). Instead of a server, the catalog lives
as five parallel device arrays sorted lexicographically by key:

    key_hi, key_lo, key_ex : uint32   -- sha1 bits 0..31 / 32..63 / 64..79
    song_id                : uint32
    offset                 : uint32   -- anchor frame

13M hashes (the reference's 2,714-song catalog) ≈ 260 MB — trivially HBM
resident; lookups are lane-parallel binary searches (see search.py) and
voting is one histogram pass (see match/).

Index *construction* is a host-side sort (np.lexsort) — ingest-time work
that runs once per catalog; the hot query path never leaves the device.
Per-song dedup mirrors the reference's ``INSERT IGNORE`` + unique
(song_id, offset, hash) constraint and its per-channel set-union
(``get_file_fingerprints``, reference ``__init__.py:254-266``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def offset_stride_for(max_offset: int, n_songs: int) -> int:
    """THE packing rule for (song_id, offset) -> one uint32 payload:
    power-of-two stride above ``max_offset``; 0 = unpackable (would
    overflow 32 bits).  Single-sourced — host and device index layouts
    must always agree on it or payloads decode with the wrong divisor.
    """
    stride = 1
    while stride <= max_offset:
        stride <<= 1
    if max(n_songs, 1) * stride <= (1 << 32):
        return stride
    return 0


@dataclasses.dataclass
class FingerprintIndex:
    """Sorted fingerprint store (numpy on host; `.device()` puts it in HBM)."""

    key_hi: np.ndarray
    key_lo: np.ndarray
    key_ex: np.ndarray
    song_id: np.ndarray
    offset: np.ndarray
    n_songs: int
    max_offset: int  # largest stored frame offset (sets the delta range)

    def __post_init__(self):
        n = len(self.key_hi)
        for arr in (self.key_lo, self.key_ex, self.song_id, self.offset):
            if len(arr) != n:
                raise ValueError("index arrays must be parallel")

    @property
    def n_hashes(self) -> int:
        return int(len(self.key_hi))

    @property
    def offset_stride(self) -> int:
        """Power-of-two stride for packing (song_id, offset) in one uint32.

        The expansion phase of a query is dominated by random HBM gathers
        from the payload arrays; packing halves them. 0 means the catalog
        is too large to pack (song_id * stride would overflow 32 bits) and
        the two-array layout is used instead.
        """
        return offset_stride_for(self.max_offset, self.n_songs)

    def device_arrays(self):
        """(key_hi, key_lo, key_ex, payload...) device arrays, >= 1 entry.

        Returns a 4-tuple (keys + packed payload) when packing fits, else
        the 5-tuple with separate song_id/offset arrays. Pass
        ``offset_stride`` to the matcher so it can decode.
        """
        if self.n_hashes == 0:
            z = np.zeros(1, np.uint32)
            return tuple(jnp.asarray(a) for a in (z, z, z, z))
        from .devmerge import pack_padded_cols  # lazy: devmerge imports us

        # capacity rounded to a 512 multiple: the blocked expansion
        # (match.lookup._expand_blocked) reads the payload as (N/B, B)
        # rows, and sentinel tails are inert (device-resident stores
        # already carry far larger ones)
        return pack_padded_cols(
            self.key_hi, self.key_lo, self.key_ex,
            self.song_id, self.offset,
            stride=self.offset_stride, cap=-(-self.n_hashes // 512) * 512)

    # ---- persistence ----
    def save(self, path: str) -> None:
        from ..utils.persist import atomic_savez

        atomic_savez(
            path,
            key_hi=self.key_hi, key_lo=self.key_lo, key_ex=self.key_ex,
            song_id=self.song_id, offset=self.offset,
            meta=np.array([self.n_songs, self.max_offset], np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "FingerprintIndex":
        with np.load(path) as z:
            return cls(
                key_hi=z["key_hi"], key_lo=z["key_lo"], key_ex=z["key_ex"],
                song_id=z["song_id"], offset=z["offset"],
                n_songs=int(z["meta"][0]), max_offset=int(z["meta"][1]),
            )

    # ---- per-song hash counts (reference total_hashes semantics) ----
    def hashes_per_song(self) -> np.ndarray:
        # bincount, not add.at: the ufunc loop is 10-50x slower at the
        # 95M-row production scale
        return np.bincount(
            self.song_id, minlength=self.n_songs + 1
        ).astype(np.int64)


def _sort_entries(hi, lo, ex, sid, off):
    order = np.lexsort((off, sid, ex, lo, hi))
    return hi[order], lo[order], ex[order], sid[order], off[order]


def build_index(
    per_song: Sequence[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    n_songs: Optional[int] = None,
) -> FingerprintIndex:
    """Build a sorted index from per-song fingerprint arrays.

    :param per_song: iterable of (song_id, hi, lo, ex, offsets) — already
        deduped per song (``fingerprints_to_pairs``).
    :param n_songs: catalog size; defaults to max song_id + 1.
    """
    his, los, exs, sids, offs = [], [], [], [], []
    for sid, hi, lo, ex, off in per_song:
        his.append(np.asarray(hi, np.uint32))
        los.append(np.asarray(lo, np.uint32))
        exs.append(np.asarray(ex, np.uint32))
        offs.append(np.asarray(off, np.uint32))
        sids.append(np.full(len(hi), sid, np.uint32))
    if his:
        hi = np.concatenate(his)
        lo = np.concatenate(los)
        ex = np.concatenate(exs)
        sid = np.concatenate(sids)
        off = np.concatenate(offs)
    else:
        hi = lo = ex = sid = off = np.zeros(0, np.uint32)
    hi, lo, ex, sid, off = _sort_entries(hi, lo, ex, sid, off)
    ns = n_songs if n_songs is not None else (int(sid.max()) + 1 if len(sid) else 0)
    max_off = int(off.max()) if len(off) else 0
    return FingerprintIndex(hi, lo, ex, sid, off, ns, max_off)


def merge_into(base: FingerprintIndex, addition: FingerprintIndex) -> FingerprintIndex:
    """Two-run sorted merge in ~O(n) — no full re-sort of the catalog.

    Incremental ingest appends small sorted runs to a large sorted base;
    ``merge_indices``' concat + lexsort re-sorts every row on every merge
    (O(N log N) each time, the reference's INSERT-only model never pays
    this). Here both runs are merged on the packed 64-bit (hi, lo) key
    with two searchsorteds; rows where equal (hi, lo) keys from BOTH runs
    collide get a local repair lexsort restoring (ex, sid, off) order —
    work proportional to cross-run key collisions, not catalog size.
    Output is element-identical to ``merge_indices([base, addition])``.
    """
    if base.n_hashes == 0 or addition.n_hashes == 0:
        keep = base if addition.n_hashes == 0 else addition
        return FingerprintIndex(
            keep.key_hi, keep.key_lo, keep.key_ex, keep.song_id, keep.offset,
            n_songs=max(base.n_songs, addition.n_songs),
            max_offset=max(base.max_offset, addition.max_offset),
        )
    kb = (base.key_hi.astype(np.uint64) << 32) | base.key_lo
    ka = (addition.key_hi.astype(np.uint64) << 32) | addition.key_lo
    nb, na = len(kb), len(ka)
    n = nb + na
    pos_b = np.arange(nb, dtype=np.int64) + np.searchsorted(ka, kb, "left")
    pos_a = np.arange(na, dtype=np.int64) + np.searchsorted(kb, ka, "right")

    cols = []
    for name in ("key_hi", "key_lo", "key_ex", "song_id", "offset"):
        out = np.empty(n, np.uint32)
        out[pos_b] = getattr(base, name)
        out[pos_a] = getattr(addition, name)
        cols.append(out)
    hi, lo, ex, sid, off = cols

    # repair pass: inside equal-(hi, lo) runs the minor order must be
    # (ex, sid, off); detect violations and lexsort just those runs
    k = (hi.astype(np.uint64) << 32) | lo
    same = k[1:] == k[:-1]
    disorder = same & (
        (ex[1:] < ex[:-1])
        | ((ex[1:] == ex[:-1]) & (sid[1:] < sid[:-1]))
        | ((ex[1:] == ex[:-1]) & (sid[1:] == sid[:-1]) & (off[1:] < off[:-1]))
    )
    if disorder.any():
        run_id = np.zeros(n, np.int64)
        run_id[1:] = np.cumsum(~same)
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [n]])
        bad = np.unique(run_id[1:][disorder])
        delta = np.zeros(n + 1, np.int64)
        delta[starts[bad]] += 1
        delta[ends[bad]] -= 1
        mask = np.cumsum(delta[:-1]) > 0
        idx = np.nonzero(mask)[0]
        sub = np.lexsort((off[idx], sid[idx], ex[idx], run_id[idx]))
        for arr in cols:
            arr[idx] = arr[idx][sub]

    return FingerprintIndex(
        hi, lo, ex, sid, off,
        n_songs=max(base.n_songs, addition.n_songs),
        max_offset=max(base.max_offset, addition.max_offset),
    )


def merge_indices(indices: Iterable[FingerprintIndex]) -> FingerprintIndex:
    """Merge sorted indices (incremental ingest; reference appends via SQL)."""
    indices = [ix for ix in indices if ix.n_hashes > 0]
    if not indices:
        return FingerprintIndex(*(np.zeros(0, np.uint32),) * 5, n_songs=0, max_offset=0)
    hi = np.concatenate([ix.key_hi for ix in indices])
    lo = np.concatenate([ix.key_lo for ix in indices])
    ex = np.concatenate([ix.key_ex for ix in indices])
    sid = np.concatenate([ix.song_id for ix in indices])
    off = np.concatenate([ix.offset for ix in indices])
    hi, lo, ex, sid, off = _sort_entries(hi, lo, ex, sid, off)
    return FingerprintIndex(
        hi, lo, ex, sid, off,
        n_songs=max(ix.n_songs for ix in indices),
        max_offset=max(ix.max_offset for ix in indices),
    )

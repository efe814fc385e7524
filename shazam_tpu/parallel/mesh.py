"""Device mesh helpers for sharded catalogs.

The reference's only scale-out lever was an external DB server (and an ES
``number_of_shards`` knob pinned to 1, ``elastic_database.py:42,80``).
Here the catalog shards across a ``jax.sharding.Mesh``: the sorted index
splits into contiguous key ranges, one per device, so every device owns a
disjoint slice of hash space and lookups stay local; only the vote
histograms cross the device interconnect (one psum).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SHARD_AXIS) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), (axis_name,))


def shard_index_arrays(index, n_shards: int) -> Tuple[np.ndarray, ...]:
    """Split the sorted index into n equal contiguous chunks (padded).

    Returns stacked (n_shards, rows_per_shard) arrays for the keys plus
    the payload (packed single array when ``index.offset_stride`` > 0,
    else separate song_id/offset). Padding rows carry the maximal key so
    they sort after every real key and can never match a query's
    equal-range (query ex values are 16-bit, pad ex is 2^32-1); padded
    payloads decode to song_id >= n_songs which the vote histogram drops.
    """
    n = index.n_hashes
    per = -(-max(n, 1) // n_shards)  # ceil
    total = per * n_shards

    def pad(arr, fill):
        out = np.full(total, fill, np.uint32)
        out[:n] = arr
        return out.reshape(n_shards, per)

    keys = (
        pad(index.key_hi, 0xFFFFFFFF),
        pad(index.key_lo, 0xFFFFFFFF),
        pad(index.key_ex, 0xFFFFFFFF),
    )
    stride = index.offset_stride
    if stride:
        packed = (
            index.song_id.astype(np.uint32) * np.uint32(stride)
            + index.offset.astype(np.uint32)
        )
        return keys + (pad(packed, min(index.n_songs * stride, 2 ** 32 - 1)),)
    return keys + (pad(index.song_id, index.n_songs), pad(index.offset, 0))

"""Fully on-device ingest: sorted, deduped addition runs built in HBM.

The streaming host ingest (``api._ingest_stream``) downloads every
batch's fingerprints, dedups and lexsorts them on the host, and uploads
the addition run for the device merge.  Where the device link is slow
or the host CPU is busy, those round trips dominate ingest.  This module keeps
the entire addition path on the device:

    Fingerprints batch (B, L)
      -> global 4-key ``lax.sort`` over (hi, lo, ex, song*stride+off)
      -> neighbor-equality dedup  (== the reference's per-song channel
         set-union of (hash, offset) pairs, ``__init__.py:254-266``:
         duplicate pairs collide only within a song because the payload
         encodes the song id)
      -> sentinel rekey + second sort  (dups/padding squeezed to the end)
      -> fixed-capacity run, absorbed by ``DeviceIndex.merge_device_run``

Host traffic per batch: one (B,) song-id upload and O(B) scalars down
(run length, per-song hash counts) — the samples themselves never need
a host copy at all (e.g. synthesized on device, or handed over from a
decode job), and fingerprints never leave HBM.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

SENTINEL = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("stride", "addition_cap"))
def device_sorted_run(
    hi: jnp.ndarray,
    lo: jnp.ndarray,
    ex: jnp.ndarray,
    t1: jnp.ndarray,
    valid: jnp.ndarray,
    sids: jnp.ndarray,
    *,
    stride: int,
    addition_cap: int,
) -> Tuple[Tuple, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build a DeviceIndex-layout addition run from a Fingerprints batch.

    :param hi, lo, ex, t1, valid: (B, L) columns from ``fingerprint_batch*``
        (multiple rows may belong to one song — channels union here).
    :param sids: (B,) uint32 catalog song id per row.
    :param stride: the index's packed-payload stride (must exceed every
        offset; caller runs ``DeviceIndex._ensure_layout`` first).
    :param addition_cap: static run capacity (power of two for compile
        stability of the downstream merge).
    :returns: (cols, n_run, per_song_counts, overflowed) — cols is the
        sentinel-padded sorted 4-column run; per_song_counts[i] is row
        i's song's deduped hash count (rows of one song all report the
        song total); overflowed means the valid lanes exceeded
        addition_cap (detected, never silent — caller must not merge).
    """
    bsz, lanes = hi.shape
    addition_cap = min(addition_cap, bsz * lanes)  # static clamp
    sidm = jnp.broadcast_to(sids[:, None].astype(jnp.uint32), hi.shape)
    pay = sidm * jnp.uint32(stride) + t1

    def flat(col):
        return jnp.where(valid, col, SENTINEL).reshape(-1)

    shi, slo, sex, spay = lax.sort(
        (flat(hi), flat(lo), flat(ex), flat(pay)), num_keys=4
    )
    n_valid_total = jnp.sum(valid.astype(jnp.int32))
    overflowed = n_valid_total > addition_cap

    # valid rows lead after the sort (real ex is 16-bit < SENTINEL), so
    # the static slice keeps them all whenever overflowed is False
    shi, slo, sex, spay = (
        c[:addition_cap] for c in (shi, slo, sex, spay)
    )

    # neighbor dedup = exact (hash, song, offset) set-union
    dup = jnp.zeros(addition_cap, bool).at[1:].set(
        (shi[1:] == shi[:-1])
        & (slo[1:] == slo[:-1])
        & (sex[1:] == sex[:-1])
        & (spay[1:] == spay[:-1])
    )
    live = (sex != SENTINEL) & ~dup
    n_run = jnp.sum(live.astype(jnp.int32))

    run_sid = jnp.where(live, spay // jnp.uint32(stride), SENTINEL)
    counts = jax.vmap(
        lambda s: jnp.sum((run_sid == s).astype(jnp.int32))
    )(sids.astype(jnp.uint32))

    cols = lax.sort(
        tuple(jnp.where(live, c, SENTINEL) for c in (shi, slo, sex, spay)),
        num_keys=4,
    )
    return cols, n_run, counts, overflowed

"""Sequence-parallel fingerprinting: ONE song sharded across the mesh.

The reference processes a whole song in a single ``mlab.specgram`` call,
bounded by host RAM (``__init__.py:232-237``); its longest "sequence" is
~10^7 samples. The device analog of sequence/context parallelism here
(SURVEY.md §5) is blockwise STFT with halo exchange:

- the sample axis is sharded into contiguous chunks, one per device;
- each device ppermutes a halo to its neighbors — ``radius`` frames of
  samples on each side plus the window tail, so its local spectrogram
  frames are bit-identical to the monolithic STFT and its peak-picker
  windows (21x21 => 10-frame halo) see true neighbor context;
- per-shard constellation peaks are all_gathered (tiny: capacity-bounded
  index arrays) and compacted in global (t, f) order;
- hash fan-out needs up to MAX_HASH_TIME_DELTA=200 frames of lookahead
  (reference ``__init__.py:50``), so pairing runs on the gathered peak
  set — replicated, but it is the cheap stage.

Collectives: two ppermutes (halo) + one all_gather (peaks) per step, all
over the device interconnect. Output is replicated across the mesh.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.spectrogram import spectrogram_db
from ..ops.peaks import extract_peaks
from ..ops.hashes import generate_hashes
from ..ops.fingerprint import Fingerprints


def sequence_parallel_fingerprint(
    mesh: Mesh,
    samples: jnp.ndarray,
    n_valid_samples: int | jnp.ndarray,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """Fingerprint one channel with its sample axis sharded over the mesh.

    `samples` length must be divisible by n_devices * hop. Results match
    ``fingerprint_samples`` on a single device exactly (same XLA ops, same
    frames — verified in tests/test_sequence_parallel.py).
    """
    n = samples.shape[0]
    n_dev = mesh.devices.size
    if n % (n_dev * hop):
        raise ValueError("padded length must divide n_devices * hop")
    chunk = n // n_dev
    halo_r = radius * hop + (wsize - hop)
    if chunk < halo_r:
        # a shorter chunk would silently truncate the exchanged halos,
        # breaking the promised bit-exactness at shard boundaries — the
        # clip is too short for this mesh; run it single-device instead
        raise ValueError(
            f"per-device chunk {chunk} < halo {halo_r} samples: input too "
            f"short for {n_dev}-way sequence parallelism (needs >= "
            f"{n_dev * halo_r} padded samples); use fingerprint_samples"
        )
    fn = _seq_fingerprint_program(
        mesh, n, fs=fs, wsize=wsize, hop=hop, amp_min=amp_min,
        radius=radius, fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        peak_capacity=peak_capacity,
    )
    return fn(samples, jnp.asarray(n_valid_samples, jnp.int32))


@functools.lru_cache(maxsize=64)
def _seq_fingerprint_program(
    mesh: Mesh, n: int, *, fs: int, wsize: int, hop: int, amp_min: float,
    radius: int, fan_value: int, min_dt: int, max_dt: int,
    peak_capacity: int,
):
    """Jitted sequence-parallel program, built ONCE per static config
    (a per-call closure retraced — and recompiled — on every song; see
    sharded._match_query_program).
    ``n_valid`` is an argument, not a baked closure constant, so one
    program serves every song of the same padded length."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    chunk = n // n_dev
    frames_per_dev = chunk // hop
    halo = radius * hop                     # left halo samples
    halo_r = radius * hop + (wsize - hop)   # right halo incl window tail
    cap_shard = -(-peak_capacity // n_dev)

    def local_fn(x, n_valid):
        x = x.reshape(-1)  # (chunk,)
        d = lax.axis_index(axis)

        # ---- halo exchange over the ring (edges zero-filled) ----
        right_edge = x[-halo:]                       # -> next device's left
        left_edge = x[:halo_r]                       # -> prev device's right
        perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        perm_bwd = [((i + 1) % n_dev, i) for i in range(n_dev)]
        left_halo = lax.ppermute(right_edge, axis, perm_fwd)
        right_halo = lax.ppermute(left_edge, axis, perm_bwd)
        left_halo = jnp.where(d == 0, jnp.zeros_like(left_halo), left_halo)
        right_halo = jnp.where(
            d == n_dev - 1, jnp.zeros_like(right_halo), right_halo
        )
        ext = jnp.concatenate([left_halo, x, right_halo])

        # ---- local spectrogram: frames [t0 - radius, t0 + Tc + radius) ----
        # frame i of `ext` starts at global sample (t0 - radius + i) * hop,
        # identical to the monolithic STFT's frames.
        spec = spectrogram_db(ext, fs=fs, wsize=wsize, hop=hop)  # (F, Tloc)
        t0 = d * frames_per_dev
        t_glob = jnp.arange(spec.shape[1], dtype=jnp.int32)[None, :] + (
            t0 - radius
        )
        n_valid_frames = jnp.maximum((n_valid - wsize) // hop + 1, 0)
        spec = jnp.where(
            (t_glob >= 0) & (t_glob < n_valid_frames), spec, 0.0
        )

        # ---- peaks for OWN frame range (halo provides true context) ----
        times_l, freqs_l, n_peaks_l = extract_peaks(
            spec, amp_min, radius=radius, capacity=cap_shard * 4
        )
        # keep only peaks whose frame is owned by this shard
        own = (times_l >= radius) & (times_l < radius + frames_per_dev)
        own &= jnp.arange(times_l.shape[0]) < jnp.minimum(
            n_peaks_l, jnp.uint32(cap_shard * 4)
        )
        # true own-peak count BEFORE the cap_shard clamp, plus the
        # extract_peaks capacity signal — a dense shard must not drop
        # peaks silently (the repo invariant: overflow is detected)
        cnt_raw = jnp.sum(own.astype(jnp.int32))
        over_l = (
            (n_peaks_l > jnp.uint32(cap_shard * 4)).astype(jnp.int32)
            + (cnt_raw > cap_shard).astype(jnp.int32)
        )
        # compact own peaks to cap_shard (they are already in (t, f) order)
        rank = jnp.cumsum(own.astype(jnp.int32)) - 1
        slot = jnp.where(own & (rank < cap_shard), rank, cap_shard)
        t_own = jnp.zeros(cap_shard + 1, jnp.uint32).at[slot].set(
            (times_l.astype(jnp.int32) + t0 - radius).astype(jnp.uint32),
            mode="drop",
        )[:cap_shard]
        f_own = jnp.zeros(cap_shard + 1, jnp.uint32).at[slot].set(
            freqs_l, mode="drop"
        )[:cap_shard]
        cnt_own = jnp.minimum(jnp.sum(own.astype(jnp.int32)), cap_shard)

        # ---- gather all shards' peaks; compact in global (t, f) order ----
        all_t = lax.all_gather(t_own, axis).reshape(-1)
        all_f = lax.all_gather(f_own, axis).reshape(-1)
        all_c = lax.all_gather(cnt_own, axis)              # (n_dev,)
        m = all_t.shape[0]
        pos = jnp.arange(m, dtype=jnp.int32)
        valid = (pos % cap_shard) < jnp.repeat(
            all_c, cap_shard, total_repeat_length=m
        )
        score = jnp.where(valid, (1 << 30) - 1 - pos, 0)
        vals, idx = lax.top_k(score, min(peak_capacity, m))
        ok = vals > 0
        # shards are time-ordered and in-shard order is (t, f): positional
        # order == global order
        times = jnp.where(ok, jnp.take(all_t, idx), 0)
        freqs = jnp.where(ok, jnp.take(all_f, idx), 0)
        if peak_capacity > m:
            times = jnp.pad(times, (0, peak_capacity - m))
            freqs = jnp.pad(freqs, (0, peak_capacity - m))
            ok = jnp.pad(ok, (0, peak_capacity - m))
        # report the UNclamped global count; when any shard truncated
        # (quota or extract capacity) force it above peak_capacity so the
        # caller sees the overflow exactly like single-device extract_peaks
        n_true = lax.psum(cnt_raw, axis)
        any_over = lax.psum(over_l, axis)
        n_peaks = jnp.where(
            any_over > 0,
            jnp.maximum(n_true, peak_capacity + 1),
            n_true,
        ).astype(jnp.uint32)

        # ---- hash pairing on the replicated gathered set (cheap) ----
        hi, lo, ex, t1, valid_h = generate_hashes(
            times, freqs, jnp.minimum(n_peaks, jnp.uint32(peak_capacity)),
            fan_value=fan_value, min_dt=min_dt, max_dt=max_dt,
        )
        return Fingerprints(hi, lo, ex, t1, valid_h, n_peaks)

    rep = P()
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), rep),
        out_specs=Fingerprints(rep, rep, rep, rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(fn)

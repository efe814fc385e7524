"""Stage split of the fingerprint pipeline, read from a profiler trace.

    python benchmarks/profile_pipeline.py [--out DIR]

``ops.fingerprint.fingerprint_samples`` runs its four stages under
``jax.named_scope``: spectrogram | peaks | compaction | sha1. This script
runs ``fingerprint_batch`` at two shapes (16 x 30 s songs, one 15 s
clip), traces one steady call of each with ``jax.profiler``, maps every
device event to its stage through the compiled HLO's op metadata, and
prints the device time per stage beside the least time the stage's bytes
need at the card's published memory rate. It also times the host-clock
median of the whole call (ending in ``block_until_ready``).

Device times come only from a GPU run; on another device the script
exits non-zero. The script turns XLA's CUDA-graph command buffers off
(``--xla_gpu_enable_command_buffer=``) so that every kernel event in the
trace names its HLO instruction; the stage split is summed kernel time,
which that does not change. The trace and a JSON summary go to ``--out``
(default ``chiprun_out/profile``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

STAGES = ("spectrogram", "peaks", "compaction", "sha1")
FS = 44100
# published memory rate per device kind (NVIDIA H100 SXM data sheet);
# a kind missing here is an error, not a default
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _kernel_key(name: str) -> str:
    """Kernel and HLO names compared the same way: XLA names a fusion's
    kernel after the instruction with '.' -> '_' and numbers the extra
    kernels of one instruction '__1', '__2', ..."""
    return re.sub(r"__\d+$", "", name.replace(".", "_").replace("-", "_"))


def hlo_stage_map(hlo_text: str) -> dict:
    """HLO instruction name -> stage, from the ``op_name`` metadata.

    An instruction without a stage of its own (a fusion, a call) takes
    the most common stage of the computations it calls."""
    from collections import Counter

    head = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
    inst = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
    comp, own, calls, members = None, {}, {}, {}
    for line in hlo_text.splitlines():
        m = head.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = inst.match(line)
        if not m:
            continue
        name = m.group(1)
        members.setdefault(comp, []).append(name)
        op = re.search(r'op_name="([^"]*)"', line)
        if op:
            parts = set(re.split(r"[/()]", op.group(1)))
            stage = next((s for s in STAGES if s in parts), None)
            if stage:
                own[name] = stage
        calls[name] = re.findall(r"(?:calls|body|condition|branch_computations)"
                                 r"=\{?%?([\w.\-]+)", line)

    def stage_of(name, depth=0):
        if name in own or depth > 8:
            return own.get(name)
        votes = Counter()
        for c in calls.get(name, ()):
            for sub in members.get(c, ()):
                s = stage_of(sub, depth + 1)
                if s:
                    votes[s] += 1
        return votes.most_common(1)[0][0] if votes else None

    out = {}
    for names in members.values():
        for name in names:
            s = stage_of(name)
            if s:
                out[_kernel_key(name)] = s
    return out


def device_stage_times(xplane_path: str, module: str, stage_of: dict,
                       plane_prefix: str = "/device:GPU"):
    """Per-stage sums of event durations (ns) in ``module`` over the
    planes named ``plane_prefix*``, and the union of those events'
    intervals (the device's busy time)."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    per = {s: 0 for s in STAGES}
    per["other"] = 0
    busy = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if module not in str(stats.get("hlo_module", "")):
                    continue
                key = _kernel_key(str(stats.get("hlo_op", ev.name)))
                if key not in stage_of:
                    key = _kernel_key(ev.name)
                per[stage_of.get(key, "other")] += ev.duration_ns
                busy.append((ev.start_ns, ev.end_ns))
    union, end = 0, None
    for a, b in sorted(busy):
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return per, union


def min_bytes(batch: int, blen: int, n_frames: int, n_freqs: int,
              peak_cap: int) -> dict:
    """Least bytes each stage must move (read inputs once, write outputs
    once), float32 spectrogram and bool mask."""
    spec = batch * n_freqs * n_frames * 4
    return {
        "spectrogram": batch * blen * 4 + spec,
        "peaks": spec + batch * n_freqs * n_frames,
        "compaction": batch * n_freqs * n_frames + batch * peak_cap * 8,
        "sha1": batch * peak_cap * 8 + batch * 4 * peak_cap * 20,
    }


def profile_shape(name, mat, n, out_dir, peak_rate):
    import jax
    import jax.numpy as jnp

    from shazam_tpu.config import DEFAULT_CONFIG as cfg
    from shazam_tpu.ops.fingerprint import fingerprint_batch

    cap = cfg.peak_capacity
    kw = dict(fs=cfg.sample_rate, wsize=cfg.window_size, hop=cfg.hop,
              amp_min=cfg.amp_min, radius=cfg.peak_neighborhood_size,
              fan_value=cfg.fan_value, min_dt=cfg.min_hash_time_delta,
              max_dt=cfg.max_hash_time_delta, peak_capacity=cap)
    x = jnp.asarray(mat)
    nv = jnp.asarray(np.full(mat.shape[0], n, np.int32))
    compiled = fingerprint_batch.lower(x, nv, **kw).compile()
    stage_of = hlo_stage_map(compiled.as_text())

    def call():
        return jax.block_until_ready(fingerprint_batch(x, nv, **kw))

    call()
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    trace_dir = os.path.join(out_dir, name)
    with jax.profiler.trace(trace_dir):
        call()
    with open(os.path.join(trace_dir, "module.hlo.txt"), "w") as f:
        f.write(compiled.as_text())
    xplane = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                              recursive=True))[-1]
    per, busy = device_stage_times(xplane, "fingerprint_batch", stage_of)
    n_frames = (mat.shape[1] - cfg.window_size) // cfg.hop + 1
    need = min_bytes(mat.shape[0], mat.shape[1], n_frames,
                     cfg.window_size // 2 + 1, cap)
    rows = {}
    for s in STAGES + ("other",):
        ms = per[s] / 1e6
        bound_ms = need[s] / peak_rate * 1e3 if s in need else None
        rows[s] = {"device_ms": ms, "min_bytes": need.get(s),
                   "memory_bound_ms": bound_ms}
    summary = {"shape": name, "batch": int(mat.shape[0]),
               "padded_samples": int(mat.shape[1]),
               "host_median_ms": float(np.median(times)) * 1e3,
               "device_busy_ms": busy / 1e6, "stages": rows}
    print(f"[{name}] host median {summary['host_median_ms']:.3f} ms, "
          f"device busy {summary['device_busy_ms']:.3f} ms", flush=True)
    for s, r in rows.items():
        bound = (f"{r['memory_bound_ms']:.4f} ms at the published memory "
                 f"rate" if r["memory_bound_ms"] is not None else "")
        print(f"    {s:12s} {r['device_ms']:9.4f} ms  {bound}", flush=True)
    return summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("chiprun_out", "profile"))
    args = p.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_enable_command_buffer" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_enable_command_buffer=").strip()
    import jax

    from shazam_tpu.audio.synth import synth_song
    from shazam_tpu.runtime import card_line, enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    if dev.device_kind not in PEAK_BYTES_PER_S:
        raise SystemExit(f"no published memory rate for {dev.device_kind}")
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    card = card_line().replace("\n", "; ")
    print(f"card (name, power limit): {card}; device_kind "
          f"{dev.device_kind}; jax {jax.__version__}; XLA_FLAGS "
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    os.makedirs(args.out, exist_ok=True)

    out = {"card": card, "device_kind": dev.device_kind}
    for name, batch, secs in (("16x30s", 16, 30.0), ("1x15s", 1, 15.0)):
        n = int(secs * FS)
        blen = -(-n // (1 << 18)) * (1 << 18)
        mat = np.zeros((batch, blen), np.float32)
        for i in range(batch):
            mat[i, :n] = synth_song(i, duration_s=secs, fs=FS, seed=5)
        out[name] = profile_shape(name, mat, n, args.out, peak)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

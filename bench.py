"""Headline benchmark. Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Primary metric: audio-minutes fingerprinted per second per chip (the
reference CPU pipeline manages ~0.6 — a 15 s clip in ~0.43 s, BASELINE.md).
Extras report the 5 s query p50 against a 2,714-track / ~13M-hash index
(reference: ~0.34-1.4 s including its MySQL round trip; target < 10 ms).

Runs on the first GPU JAX finds, and exits non-zero on any other device
instead of falling back. The printed extras name the platform, the
device kind and the card's name and power limit. (The measurement
functions themselves run anywhere; the tests drive them on the CPU.)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

REFERENCE_AUDIO_MIN_PER_S = 0.6     # BASELINE.md: ~15 s clip in ~0.43 s
REFERENCE_QUERY_P50_S = 0.82        # BASELINE.md: DB query p50 at 2,035 songs


def bench_fingerprint_throughput(jax, jnp, seconds_per_song=30.0, batch=16,
                                 chain=16):
    """Device-honest throughput: K iterations chained inside one jitted
    fori_loop (each consuming ALL outputs of a varied input), timed as
    (T_chain - T_1) / (chain - 1). This defeats both async-dispatch
    under-counting and XLA dead-code elimination — naive per-call timing
    measures the enqueue, not the device work.
    """
    import functools
    from jax import lax
    from shazam_tpu.ops.fingerprint import fingerprint_batch
    from shazam_tpu.audio.synth import synth_song

    fs = 44100
    n = int(seconds_per_song * fs)
    blen = -(-n // (1 << 18)) * (1 << 18)  # linear bucket, like the API
    mat = np.zeros((batch, blen), np.float32)
    for i in range(batch):
        mat[i, :n] = synth_song(i, duration_s=seconds_per_song, fs=fs, seed=5)
    mat_d = jnp.asarray(mat)
    nv_d = jnp.asarray(np.full(batch, n, np.int32))

    @functools.partial(jax.jit, static_argnames=("k",))
    def loop(x, k):
        def body(i, acc):
            fp = fingerprint_batch(
                jnp.roll(x, i, axis=0) + acc * 1e-30, nv_d, peak_capacity=4096
            )
            s = sum(jnp.sum(l.astype(jnp.float32))
                    for l in jax.tree_util.tree_leaves(fp))
            return acc + s
        return lax.fori_loop(0, k, body, jnp.float32(0))

    # One compiled program; the k-iteration chain amortizes the
    # host<->device round trip to <= RTT/k, so the reported number is
    # conservative (true device throughput is higher).
    float(loop(mat_d, chain))  # compile
    best = []
    for _ in range(3):
        t0 = time.time()
        float(loop(mat_d, chain))
        best.append(time.time() - t0)
    dt = max(min(best) / chain, 1e-6)
    audio_minutes = batch * seconds_per_song / 60.0
    return audio_minutes / dt, dt


# catalog_full.py CATALOG_SAVE builds, most production-like first:
# music8192 is the reference's real deployment scale (~93M hashes,
# fingerprints_queries.sql:2) with realistic music hash skew;
# prod12288 is the same scale on the tone corpus (pathologically
# hot hashes — a typical 15 s pack expands to ~210K rows);
# music2714/cat2714 are the 2,714-track headline shape (~30M hashes).
REAL_DB_PREFIXES = tuple(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data", name)
    for name in ("music8192", "prod12288", "music2714", "cat2714"))


def bench_query_latency_real(jax, jnp, chain=32):
    """Query p50 against a REAL fingerprint index when a catalog_full.py
    CATALOG_SAVE build is on disk (prefix.idx.npz + prefix.queries.npz:
    full-length tracks, real 15 s-clip query packs fingerprinted through
    the production path). Returns None when no snapshot is present
    (fresh clone) — the synthetic-keyed bench below is the fallback and
    extras say which ran.
    """
    prefix = next((p for p in REAL_DB_PREFIXES
                   if os.path.exists(p + ".idx.npz")
                   and os.path.exists(p + ".queries.npz")), None)
    if prefix is None:
        return None

    import functools
    from jax import lax
    from shazam_tpu.index.store import FingerprintIndex
    from shazam_tpu.index.search import build_unique_view, maybe_build_head
    from shazam_tpu.match.lookup import match_query, match_query_sparse
    from shazam_tpu.match.prepare import q_frames_for_max_offset

    index = FingerprintIndex.load(prefix + ".idx.npz")
    qz = np.load(prefix + ".queries.npz")
    n_songs = int(qz["n_songs"])
    dev = index.device_arrays()
    head = maybe_build_head(dev[0])
    # the API serves host-backed flat indexes through the unique-key
    # table (api._ensure_uview) — the headline must measure the same
    uview, usteps = build_unique_view(index.key_hi, index.key_lo,
                                      index.key_ex)
    packs = tuple(jnp.asarray(qz[k]) for k in
                  ("hi", "lo", "ex", "t", "valid", "first"))
    qn = int(qz["hi"].shape[0])

    clip_frames = int(qz["clip_samples"]) // 2048 + 1
    delta_min = -q_frames_for_max_offset(clip_frames)
    delta_range = ((index.max_offset // 4096) + 1) * 4096 \
        + q_frames_for_max_offset(clip_frames)
    kw = dict(n_songs=n_songs, delta_min=delta_min,
              delta_range=delta_range, topn=2,
              offset_stride=index.offset_stride)
    # mirror the API's regime split (api.py): the dense histogram costs
    # ~0.5 GB/query at 12K songs — production serves such catalogs
    # through the sparse vote matcher, so the headline must too
    matcher = (match_query_sparse
               if n_songs * delta_range > 16_000_000 else match_query)

    # measure the PRODUCTION POLICY (api._match_prepared). At indexes
    # past config.bounds_probe_min_rows (2^25) that is BOUNDS-FIRST: a
    # exact-total probe (match/lookup.query_total), then ONE
    # dispatch at the per-pack fitting tier using the escalated-tier
    # program (scatter-free scan rank + block-gather expansion with the
    # nonempty-run budget — element-identical to scalar+sort, tested).
    # Per-pack cost = t_bounds + (fits fast ? t_fast : t_tier[fit]),
    # and the headline is the p50 of that over the real query packs.
    # Smaller indexes keep the fast-tier-first policy with the
    # provably-exact early accept (config.decision_escalation).
    # NB: dev/head MUST flow through jit as arguments, never closures —
    # closed-over device arrays are baked into the HLO as constants, and
    # an index's columns as constants make a program of gigabytes.
    from shazam_tpu.config import DEFAULT_CONFIG as _cfg
    from shazam_tpu.match.lookup import query_total

    fast_cap = _cfg.match_capacity_fast
    tiers = [fast_cap, _cfg.match_capacity]
    while tiers[-1] < _cfg.match_capacity_max:
        step = 2 if tiers[-1] >= _cfg.match_tier_fine_from else 4
        tiers.append(min(tiers[-1] * step, _cfg.match_capacity_max))
    n_rows_dev = int(dev[3].shape[0])
    bounds_first = (matcher is match_query_sparse
                    and _cfg.bounds_probe_min_rows
                    and n_rows_dev >= _cfg.bounds_probe_min_rows)
    eblk = (_cfg.expand_block
            if index.offset_stride and n_rows_dev % max(
                _cfg.expand_block, 1) == 0 else 0)

    pol = _cfg.escalation_policy
    decide_mode = bool(bounds_first
                       and (pol == "decide"
                            or (pol == "auto" and _cfg.decision_escalation)))
    decide_cap = next(
        (c for c in tiers
         if c >= (_cfg.decide_capacity or _cfg.match_capacity)),
        tiers[-1])
    b_dec = eblk if decide_cap >= _cfg.expand_block_min_capacity else 0
    if decide_mode:
        # the PRODUCTION first dispatch: match at the decide tier,
        # bounds returned for the (rare) fitted re-dispatch. A serving
        # process SELF-TUNES this tier (config.decide_adapt_window:
        # while more than half a window's dispatches are undecided, the
        # tier steps up, capped at decide_adapt_max) — the headline
        # must price the converged steady state, so the same rule runs
        # here over the real packs before timing.
        def probe_at(cap_d):
            bb = eblk if cap_d >= _cfg.expand_block_min_capacity else 0
            f = jax.jit(functools.partial(
                match_query_sparse, match_capacity=cap_d,
                u_steps=usteps, vote_rank="scan", expand_block=bb,
                expand_runs=_cfg.expand_block_runs, with_bounds=True,
                **kw))
            rows_, und_ = [], []
            for i in range(qn):
                r, _lb, _ub = f(dev, *(a[i] for a in packs), head=head,
                                uview=uview)
                r = jax.device_get(r)
                total = int(r.total_rows)
                rows_.append(total)
                und_.append(
                    (total > cap_d or int(r.n_dropped) > 0)
                    and not (int(r.top_votes[0]) - int(r.runner_votes)
                             > int(r.n_dropped)))
            return rows_, und_

        rows, undecided = probe_at(decide_cap)
        adapted_from = decide_cap
        while (_cfg.decide_adapt_window
               and sum(undecided) * 2 > qn):
            nxt = next((c for c in tiers if c > decide_cap), None)
            if nxt is None or nxt > _cfg.decide_adapt_max:
                break
            decide_cap = nxt
            rows, undecided = probe_at(decide_cap)
        b_dec = eblk if decide_cap >= _cfg.expand_block_min_capacity \
            else 0
    else:
        probe0 = jax.jit(functools.partial(
            matcher, match_capacity=fast_cap, u_steps=usteps, **kw))
        rows, undecided = [], []
        for i in range(qn):
            r = probe0(dev, *(a[i] for a in packs), head=head, uview=uview)
            total = int(r.total_rows)
            rows.append(total)
            undecided.append(
                total > fast_cap
                and not (int(r.top_votes[0]) - int(r.runner_votes)
                         > int(r.n_dropped)))
    max_rows = max(rows)
    fits = [next((c for c in tiers if c >= t), tiers[-1]) for t in rows]

    def time_chain(fn):
        @functools.partial(jax.jit, static_argnames=("k",))
        def loop(qs, dev, head, uview, k):
            def body(i, acc):
                q = tuple(lax.dynamic_index_in_dim(a, i % qn, 0,
                                                   keepdims=False)
                          for a in qs)
                out = fn(dev, q, head, uview)
                s = sum(jnp.sum(l.astype(jnp.float32))
                        for l in jax.tree_util.tree_leaves(out))
                return acc + s
            return lax.fori_loop(0, k, body, jnp.float32(0))

        # (T_k - T_1)/(k - 1): the 1-iteration chain carries the same
        # dispatch + round trip as the k-iteration one, so the
        # difference is pure device time per query (dividing T_k by k
        # would smear ~RTT/k of host latency into a sub-ms device number)
        res = {}
        for k in (1, chain):
            float(loop(packs, dev, head, uview, k))  # compile
            best = []
            for _ in range(3):
                t0 = time.time()
                float(loop(packs, dev, head, uview, k))
                best.append(time.time() - t0)
            res[k] = min(best)
        return max((res[chain] - res[1]) / (chain - 1), 1e-6)

    def tier_fn(cap, with_probe=False):
        if matcher is match_query_sparse:
            b = eblk if cap >= _cfg.expand_block_min_capacity else 0
            if with_probe:
                # the REAL production pair fused for chained timing:
                # exact-total probe + fitted match REUSING the probe's
                # bounds (api._match_prepared passes them through; the
                # descent runs once, not twice)
                def f(dv, q, hd, uv):
                    total, lb, ub = query_total(
                        dv, q[0], q[1], q[2], q[4], head=hd, uview=uv,
                        u_steps=usteps, with_bounds=True)
                    return (total, match_query_sparse(
                        dv, *q, match_capacity=cap, head=hd, uview=uv,
                        u_steps=usteps, vote_rank="scan", expand_block=b,
                        expand_runs=_cfg.expand_block_runs,
                        bounds=(lb, ub), **kw))
                return f
            return lambda dv, q, hd, uv: match_query_sparse(
                dv, *q, match_capacity=cap, head=hd, uview=uv,
                u_steps=usteps, vote_rank="scan", expand_block=b,
                expand_runs=_cfg.expand_block_runs, **kw)
        return lambda dv, q, hd, uv: matcher(
            dv, *q, match_capacity=cap, head=hd, uview=uv,
            u_steps=usteps, **kw)

    policy = {"tier_ladder": "x4 to 262144 then x2"}
    if decide_mode:
        # decided-first: per-pack cost = the decide-tier dispatch, plus
        # (undecided only) the fitted re-dispatch REUSING the returned
        # bounds — timed as the fused pair, the real production chain
        def decide_fn(dv, q, hd, uv):
            return match_query_sparse(
                dv, *q, match_capacity=decide_cap, head=hd, uview=uv,
                u_steps=usteps, vote_rank="scan", expand_block=b_dec,
                expand_runs=_cfg.expand_block_runs, with_bounds=True,
                **kw)

        def pair_fn(cap):
            bb = eblk if cap >= _cfg.expand_block_min_capacity else 0

            def f(dv, q, hd, uv):
                r1, lb, ub = match_query_sparse(
                    dv, *q, match_capacity=decide_cap, head=hd,
                    uview=uv, u_steps=usteps, vote_rank="scan",
                    expand_block=b_dec,
                    expand_runs=_cfg.expand_block_runs,
                    with_bounds=True, **kw)
                r2 = match_query_sparse(
                    dv, *q, match_capacity=cap, head=hd, uview=uv,
                    u_steps=usteps, vote_rank="scan", expand_block=bb,
                    expand_runs=_cfg.expand_block_runs,
                    bounds=(lb, ub), **kw)
                return r1, r2
            return f

        t_dec = time_chain(decide_fn)
        und_fits = sorted({max(f, decide_cap)
                           for f, u in zip(fits, undecided) if u})
        t_pair = {c: time_chain(pair_fn(c)) for c in und_fits}
        per_pack = sorted(
            (t_pair[max(f, decide_cap)] if u else t_dec)
            for f, u in zip(fits, undecided))
        esc_rate = sum(undecided) / qn
        policy.update({
            "policy": "decided-first (margin-certified dispatch at the "
                      "self-tuned decide tier; undecided re-dispatch "
                      "at the fitting tier, bounds reused)",
            "decide_tier": decide_cap,
            "decide_tier_configured": adapted_from,
            "decide_tier_ms": round(t_dec * 1000, 3),
            "undecided_pair_ms": {c: round(v * 1000, 3)
                                  for c, v in t_pair.items()},
            "escalation_rate": round(esc_rate, 3),
        })
        fit_repr = max(und_fits) if und_fits else decide_cap
        p50 = per_pack[qn // 2]
        return (p50, max_rows, index.n_hashes, n_songs, fit_repr,
                esc_rate, t_dec, policy)

    t_fast = time_chain(lambda dv, q, hd, uv: matcher(
        dv, *q, match_capacity=fast_cap, head=hd, uview=uv,
        u_steps=usteps, **kw))
    policy["fast_tier_ms"] = round(t_fast * 1000, 3)
    if bounds_first:
        t_bounds = time_chain(lambda dv, q, hd, uv: query_total(
            dv, q[0], q[1], q[2], q[4], head=hd, uview=uv,
            u_steps=usteps))
        # probe+fitted-tier as ONE fused chain body — the per-query
        # device cost of the whole policy at that tier
        t_tier = {c: time_chain(tier_fn(c, with_probe=True))
                  for c in sorted(set(f for f, t in zip(fits, rows)
                                      if t > fast_cap))}
        t_fast_probed = (time_chain(tier_fn(fast_cap, with_probe=True))
                         if any(t <= fast_cap for t in rows) else 0.0)
        per_pack = sorted(
            (t_fast_probed if t <= fast_cap else t_tier[f])
            for t, f in zip(rows, fits))
        esc_rate = sum(t > fast_cap for t in rows) / qn
        policy.update({
            "policy": "bounds-first (exact-total probe -> fitting tier, "
                      "bounds reused)",
            "bounds_probe_ms": round(t_bounds * 1000, 3),
            "probe_plus_tier_ms": {c: round(v * 1000, 3)
                                   for c, v in t_tier.items()},
            "escalation_rate": round(esc_rate, 3),
        })
        fit_repr = max(t_tier) if t_tier else fast_cap
    else:
        fit_cap = fast_cap
        need = max((rows[i] for i in range(qn) if undecided[i]),
                   default=0)
        fit_cap = next((c for c in tiers if c >= need), tiers[-1]) \
            if need else fast_cap
        t_fit = time_chain(tier_fn(fit_cap)) if any(undecided) else 0.0
        per_pack = sorted(t_fast + (t_fit if u else 0.0)
                          for u in undecided)
        esc_rate = sum(undecided) / qn
        policy.update({
            "policy": "fast tier + provably-exact early accept",
            "escalated_tier_ms": round(t_fit * 1000, 3),
            "escalation_rate": round(esc_rate, 3),
        })
        fit_repr = fit_cap if any(undecided) else fast_cap
    p50 = per_pack[qn // 2]
    return (p50, max_rows, index.n_hashes, n_songs, fit_repr, esc_rate,
            t_fast, policy)


def bench_query_latency(jax, jnp, n_songs=2714, n_hashes=13_000_000,
                        q_pairs=1024, iters=50):
    from shazam_tpu.match.lookup import match_query
    from shazam_tpu.index.store import FingerprintIndex

    rng = np.random.default_rng(1)
    # realistic skew: 20% of rows use a 100k popular-hash pool
    n_pop = 100_000
    pop_hi = rng.integers(0, 2 ** 32, n_pop, dtype=np.uint32)
    pop_lo = rng.integers(0, 2 ** 32, n_pop, dtype=np.uint32)
    pop_ex = rng.integers(0, 2 ** 16, n_pop, dtype=np.uint32)

    hi = rng.integers(0, 2 ** 32, n_hashes, dtype=np.uint32)
    lo = rng.integers(0, 2 ** 32, n_hashes, dtype=np.uint32)
    ex = rng.integers(0, 2 ** 16, n_hashes, dtype=np.uint32)
    pop_rows = rng.random(n_hashes) < 0.2
    pick = rng.integers(0, n_pop, n_hashes)
    hi[pop_rows] = pop_hi[pick[pop_rows]]
    lo[pop_rows] = pop_lo[pick[pop_rows]]
    ex[pop_rows] = pop_ex[pick[pop_rows]]

    sid = rng.integers(0, n_songs, n_hashes, dtype=np.uint32)
    max_off = 5200  # ~4 min songs in frames
    off = rng.integers(0, max_off, n_hashes, dtype=np.uint32)
    order = np.lexsort((ex, lo, hi))
    index = FingerprintIndex(hi[order], lo[order], ex[order],
                             sid[order], off[order], n_songs, max_off)
    dev = index.device_arrays()
    # bucket-CDF head, exactly as the serving path builds it (api.py
    # _ensure_head): exact per-lane search windows, distribution-proof
    from shazam_tpu.index.search import maybe_build_head
    head = maybe_build_head(dev[0])

    # query: half existing keys (some popular), half misses
    qi = rng.integers(0, n_hashes, q_pairs // 2)
    q_hi = np.concatenate([hi[order][qi],
                           rng.integers(0, 2 ** 32, q_pairs - q_pairs // 2,
                                        dtype=np.uint32)])
    q_lo = np.concatenate([lo[order][qi],
                           rng.integers(0, 2 ** 32, q_pairs - q_pairs // 2,
                                        dtype=np.uint32)])
    q_ex = np.concatenate([ex[order][qi],
                           rng.integers(0, 2 ** 16, q_pairs - q_pairs // 2,
                                        dtype=np.uint32)])
    q_t = rng.integers(0, 320, q_pairs).astype(np.uint32)
    q_valid = np.ones(q_pairs, bool)
    q_first = np.ones(q_pairs, bool)

    args = tuple(jnp.asarray(a) for a in (q_hi, q_lo, q_ex, q_t, q_valid, q_first))
    delta_min = -1024
    delta_range = ((max_off // 4096) + 1) * 4096 + 2048

    import functools
    from jax import lax

    chain = 32

    @functools.partial(jax.jit, static_argnames=("k",))
    def loop(qs, dev, head, k):
        def body(i, acc):
            rolled = tuple(jnp.roll(a, i) for a in qs)
            out = match_query(
                dev, *rolled,
                n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
                # the serving path's fast tier (fits this query's ~2.8K
                # matched rows; the API retries at 64K on overflow)
                match_capacity=16384, topn=2,
                offset_stride=index.offset_stride, head=head,
            )
            s = sum(jnp.sum(l.astype(jnp.float32))
                    for l in jax.tree_util.tree_leaves(out))
            return acc + s
        return lax.fori_loop(0, k, body, jnp.float32(0))

    # single compiled chain; amortized timing is conservative (see above)
    float(loop(args, dev, head, chain))  # compile
    best = []
    for _ in range(3):
        t0 = time.time()
        float(loop(args, dev, head, chain))
        best.append(time.time() - t0)
    per_query = max(min(best) / chain, 1e-6)

    out = match_query(
        dev, *args,
        n_songs=n_songs, delta_min=delta_min, delta_range=delta_range,
        match_capacity=16384, topn=2,
        offset_stride=index.offset_stride, head=head,
    )
    return per_query, int(out.total_rows)


def main():
    import jax
    import jax.numpy as jnp

    from shazam_tpu.runtime import card_line, enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    card = card_line()
    fp_throughput, fp_dt = bench_fingerprint_throughput(jax, jnp)

    real = None
    try:
        real = bench_query_latency_real(jax, jnp)
    except Exception as e:   # never lose the headline to a stale snapshot
        print(f"# real-index query bench failed, falling back: {e!r}")
    if real is not None:
        (q_p50, q_rows, q_idx_hashes, q_idx_songs, q_cap, q_esc,
         q_fast, q_policy) = real
        q_extras = {
            "query_p50_ms_real_index": round(q_p50 * 1000, 3),
            "query_index": f"{q_idx_songs} real 210s tracks, "
                           f"{q_idx_hashes} real hashes, 15s-clip packs",
            # production policy (api._match_prepared): bounds-first at
            # production scale, fast tier + provably-exact early accept
            # below it — see bench_query_latency_real
            "query_policy": dict(q_policy,
                                 escalated_match_capacity=q_cap),
        }
    else:
        q_p50, q_rows = bench_query_latency(jax, jnp)
        q_extras = {
            "query_p50_ms_2714trk_13Mhash": round(q_p50 * 1000, 3),
            "query_index": "synthetic keys (no .data/cat2714 snapshot)",
        }

    result = {
        "metric": "audio_minutes_fingerprinted_per_sec_per_chip",
        "value": round(fp_throughput, 2),
        "unit": "audio-min/s",
        "vs_baseline": round(fp_throughput / REFERENCE_AUDIO_MIN_PER_S, 2),
        "extras": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card,
            "fingerprint_batch_seconds": round(fp_dt, 5),
            **q_extras,
            "query_p50_vs_baseline_speedup": round(REFERENCE_QUERY_P50_S / q_p50, 1),
            "query_matched_rows": q_rows,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

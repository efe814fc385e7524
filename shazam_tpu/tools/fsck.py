"""Index/catalog integrity checker (``shazam-tpu fsck``).

The reference's integrity story was hand-run SQL (row counts, orphan
deletes — ``fingerprints_queries.sql:1-6``, ``songs_queries.sql:1-11``)
plus the ``DELETE_UNFINGERPRINTED`` startup purge.  This is the
first-class equivalent: one command that validates every invariant the
matcher relies on and reconciles the index against the catalog.

Checks (host-resident index):

- key columns lexicographically sorted (binary search soundness);
- ``song_id < n_songs`` and ``offset <= max_offset`` (payload packing
  and vote-histogram bounds);
- per-song index row counts equal the catalog's ``total_hashes`` for
  every fingerprinted song (the crash signature ``load_index``
  reconciles — a fingerprinted flag without rows — is an ERROR here);
- index rows belonging to songs the catalog does not know (ERROR).

Device-resident stores (``DeviceIndex`` / ``SpannedDeviceStore``) are
checked span-by-span with streaming device reductions only — a
sortedness scan and a payload max — never a row-scale scatter (a
histogram over 436M rows; per-song counts at that scale come from the
catalog totals vs ``n_valid`` instead).

Catalog-side (always):

- fingerprinted songs with zero recorded hashes (WARNING);
- unfingerprinted leftovers (WARNING — purged on next open);
- duplicate file SHA-1s (WARNING — the resume dedup keys on it).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _lexi_sorted_host(hi, lo, ex) -> bool:
    if len(hi) < 2:
        return True
    a, b = (hi[:-1], lo[:-1], ex[:-1]), (hi[1:], lo[1:], ex[1:])
    ok = (b[0] > a[0]) | ((b[0] == a[0]) & (
        (b[1] > a[1]) | ((b[1] == a[1]) & (b[2] >= a[2]))))
    return bool(np.all(ok))


def _span_device_checks(cols, n_valid: int, stride: int):
    """(sorted_ok, payload_max) for one span's valid prefix — one
    streaming device program, shape-stable across same-capacity spans."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(hi, lo, ex, payload, n_valid):
        nxt, cur = (hi[1:], lo[1:], ex[1:]), (hi[:-1], lo[:-1], ex[:-1])
        ok = (nxt[0] > cur[0]) | ((nxt[0] == cur[0]) & (
            (nxt[1] > cur[1]) | ((nxt[1] == cur[1]) & (nxt[2] >= cur[2]))))
        pair_live = jnp.arange(hi.shape[0] - 1) < n_valid - 1
        row_live = jnp.arange(payload.shape[0]) < n_valid
        return (jnp.all(ok | ~pair_live),
                jnp.max(jnp.where(row_live, payload, 0)))

    s_ok, p_max = jax.device_get(
        run(*cols[:4], np.int32(n_valid)))
    return bool(s_ok), int(p_max)


def check_integrity(sia, deep: bool = True) -> Dict:
    """Validate ``sia``'s live index + catalog; returns a report dict
    with ``ok`` / ``errors`` / ``warnings`` / ``checks``."""
    errors: List[str] = []
    warnings: List[str] = []
    checks: Dict[str, object] = {}

    catalog_hashes = sia.catalog.song_hashes_by_id()
    songs = {d["song_id"]: d for d in sia.catalog.get_songs()}

    # ---- catalog-side ---------------------------------------------------
    zero = [sid for sid in songs if catalog_hashes.get(sid, 0) == 0]
    if zero:
        warnings.append(
            f"{len(zero)} fingerprinted song(s) with zero recorded hashes "
            f"(ids {zero[:5]}{'...' if len(zero) > 5 else ''})")
    pending = sia.catalog.conn.execute(
        "SELECT COUNT(*) FROM songs WHERE fingerprinted = 0").fetchone()[0]
    if pending:
        warnings.append(f"{pending} unfingerprinted song row(s) — "
                        "purged on next catalog open")
    dup = sia.catalog.conn.execute(
        "SELECT file_sha1, COUNT(*) c FROM songs WHERE fingerprinted = 1 "
        "GROUP BY file_sha1 HAVING c > 1").fetchall()
    if dup:
        warnings.append(
            f"{len(dup)} duplicate file SHA-1(s) among fingerprinted songs "
            "(ingest resume dedups on SHA-1; duplicates suggest a hand-"
            "edited catalog)")
    checks["catalog_songs"] = len(songs)
    catalog_total = sum(catalog_hashes.get(sid, 0) for sid in songs)
    checks["catalog_hashes"] = catalog_total

    # ---- index-side -----------------------------------------------------
    store = sia._dev_store
    if store is not None:
        checks["store"] = type(store).__name__
        n_live = store.n_valid
        spans = getattr(store, "spans", [store])
        sorted_ok, p_max = True, 0
        n_spans = n_pending = 0
        for span in spans:
            if span.n_valid == 0:
                continue
            if span._unsorted:
                # Deferred-sort appends are SUPPOSED to be unsorted until
                # finalize() — check the payload bound only.
                n_pending += 1
                _, s_max = _span_device_checks(
                    span.cols, span.n_valid, span.stride)
                p_max = max(p_max, s_max)
                continue
            n_spans += 1
            s_ok, s_max = _span_device_checks(
                span.cols, span.n_valid, span.stride)
            sorted_ok &= s_ok
            p_max = max(p_max, s_max)
        if n_pending:
            warnings.append(
                f"{n_pending} span(s) hold deferred-sort appends — "
                "queries require finalize() first (sortedness not "
                "checked for those)")
        stacked = getattr(store, "_stacked", None)
        if stacked is not None:
            for i, nv in enumerate(store._stacked_valids):
                if nv == 0:
                    continue
                n_spans += 1
                s_ok, s_max = _span_device_checks(
                    tuple(c[i] for c in stacked), nv, store.stride)
                sorted_ok &= s_ok
                p_max = max(p_max, s_max)
        checks["spans_checked"] = n_spans
        if not sorted_ok:
            errors.append("device span key columns are not sorted "
                          "(binary search would be unsound)")
        stride = store.stride
        if stride and store.n_songs and p_max >= store.n_songs * stride:
            errors.append(
                f"packed payload max {p_max} exceeds n_songs*stride "
                f"({store.n_songs}*{stride}) — song id or offset out of "
                "range")
        checks["index_hashes"] = n_live
        if n_live != catalog_total:
            errors.append(
                f"index holds {n_live} rows but the catalog records "
                f"{catalog_total} — reconcile with load_index or "
                "re-ingest the difference")
    else:
        ix = sia.index
        checks["store"] = "FingerprintIndex"
        checks["index_hashes"] = ix.n_hashes
        if not _lexi_sorted_host(ix.key_hi, ix.key_lo, ix.key_ex):
            errors.append("index key columns are not sorted "
                          "(binary search would be unsound)")
        if ix.n_hashes:
            if int(ix.song_id.max()) >= max(ix.n_songs, 1):
                errors.append(
                    f"song_id max {int(ix.song_id.max())} >= n_songs "
                    f"{ix.n_songs}")
            if int(ix.offset.max()) > ix.max_offset:
                errors.append(
                    f"offset max {int(ix.offset.max())} > max_offset "
                    f"{ix.max_offset} (vote-histogram bounds violated)")
        if ix.n_hashes != catalog_total:
            errors.append(
                f"index holds {ix.n_hashes} rows but the catalog records "
                f"{catalog_total}")
        if deep and ix.n_hashes:
            per_song = np.bincount(
                ix.song_id, minlength=max(ix.n_songs, 1))
            mismatched = []
            for sid, want in catalog_hashes.items():
                got = int(per_song[sid]) if sid < len(per_song) else 0
                if got != want:
                    mismatched.append((sid, want, got))
            orphans = [sid for sid in np.nonzero(per_song)[0]
                       if int(sid) not in catalog_hashes]
            if mismatched:
                errors.append(
                    f"{len(mismatched)} song(s) whose index row count "
                    f"disagrees with the catalog (first: song "
                    f"{mismatched[0][0]} catalog={mismatched[0][1]} "
                    f"index={mismatched[0][2]})")
            if orphans:
                errors.append(
                    f"{len(orphans)} song id(s) present in the index but "
                    f"unknown to the catalog (first: {int(orphans[0])})")
            checks["songs_reconciled"] = len(catalog_hashes)

    return {"ok": not errors, "errors": errors, "warnings": warnings,
            "checks": checks}

"""Fingerprinting configuration.

One frozen dataclass carrying every knob of the reference pipeline
(constants at reference ``__init__.py:41-51`` and the per-script config
blocks, e.g. ``recognizer_test.py:36-57``), plus the static capacities a
device pipeline needs (XLA traces fixed shapes, so dynamic peak/hash counts
become capacity + validity masks).

Defaults are numerically identical to the reference.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class FingerprintConfig:
    """All knobs of the fingerprint pipeline (reference ``__init__.py:41-51``)."""

    # --- audio / spectrogram ---
    sample_rate: int = 44100          # RATE
    window_size: int = 4096           # DEFAULT_WINDOW_SIZE (NFFT)
    overlap_ratio: float = 0.5        # DEFAULT_OVERLAP_RATIO
    # --- constellation peaks ---
    amp_min: float = 10.0             # DEFAULT_AMP_MIN (dB, strict >)
    peak_neighborhood_size: int = 10  # PEAK_NEIGHBORHOOD_SIZE
    connectivity_mask: int = 2        # CONNECTIVITY_MASK (2 => full square)
    peak_sort: bool = True            # PEAK_SORT
    # --- hash pairing ---
    fan_value: int = 5                # DEFAULT_FAN_VALUE (anchor pairs with next fan-1)
    min_hash_time_delta: int = 0      # MIN_HASH_TIME_DELTA (frames)
    max_hash_time_delta: int = 200    # MAX_HASH_TIME_DELTA (frames)
    fingerprint_reduction: int = 20   # FINGERPRINT_REDUCTION (hex chars kept = 80 bits)
    # --- static capacities (device-only concept; overflow is detected, never silent) ---
    peak_capacity: int = 8192         # max constellation peaks per channel
    hash_capacity: int = 32768        # max hashes per channel (<= 4 * peak_capacity)
    # max expanded (row x query-offset) vote entries. Expansion cost is
    # ~linear in this cap (random HBM gathers), so queries first run at
    # match_capacity_fast and only retry at match_capacity when the true
    # match count overflows it; overflow of the large cap is reported
    # (MatchResult.overflowed).
    match_capacity: int = 65536
    match_capacity_fast: int = 16384
    # ceiling for overflow-retry escalation (x4 per tier): hyper-common
    # hashes (shared motifs/percussion across a big catalog) can expand a
    # single query to hundreds of thousands of rows; the reference
    # expands ALL rows via SQL, so parity demands counting them
    match_capacity_max: int = 1 << 22
    # provably-exact early accept: the expansion includes whole runs
    # shortest-first within the tier budget and counts excluded runs,
    # each of which can add at most ONE vote to any (song, delta) bin —
    # when top1 - strongest_challenger > n_dropped, the top-1 song and
    # its offset are EXACTLY what the escalated full expansion would
    # return, so the re-dispatch is skipped (match/lookup.RawMatch).
    # Reported vote/row counts then reflect the included runs (lower
    # bounds), like the reference's own apriori partial-scan mode; set
    # False to force full-expansion counts on every overflow.
    decision_escalation: bool = True
    # candidate-pruned vote rank (big catalogs): hashed vote-count
    # upper bounds select the top-rank_candidates songs, the exact dense
    # histogram is built only for those, and an exactness certificate
    # selects between the pruned result and an in-program sort-rank
    # fallback (match/lookup._pruned_vote_rank) — element-identical to
    # the full sort either way, but the O(cap log cap) vote sort that
    # dominates escalated capacities is only paid when the certificate
    # fails (weak, tie-heavy top votes).  0 disables (always sort).
    rank_candidates: int = 256
    # vote-rank algorithm for the sparse matchers: "pruned" = the
    # candidate-pruned rank above when rank_candidates > 0 (sort
    # otherwise); "sort" = the segment-scatter sort rank; "scan" = the
    # scatter-free sort+scan rank (match/lookup._scan_vote_rank);
    # "auto" = pruned at the fast tier and scan at escalated tiers (the
    # scatter ranks pay a read-modify-write per stream element there) —
    # element-identical results in every case (tested); they differ only
    # in per-element device-memory cost. The choice per tier is queued
    # for re-derivation from measured cells (ROADMAP queue 1)
    vote_rank: str = "auto"
    # block-gather expansion width for the sparse matchers: matched rows
    # are contiguous runs, read as aligned (N/B, B) payload rows —
    # sequential reads instead of per-row random gathers. 0 = scalar
    # gathers. Requires the packed
    # payload layout with capacity a multiple of the width; the api
    # falls back to scalar when the layout can't support it
    expand_block: int = 128
    # blocked expansion only pays past this match capacity: the static
    # block budget adds 2 * expand_block_runs * expand_block stream
    # elements, which dwarfs the fast tier's own capacity; below this the api
    # uses scalar expansion
    expand_block_min_capacity: int = 65536
    # nonempty-run budget for the blocked expansion's static block
    # count (cap/B + 2*runs blocks): every rank pass downstream costs
    # per STREAM element and query packs pad lanes
    # to a pow2 bucket, so budgeting for all padded lanes (4096 at the
    # bench packs) more than doubles the escalated-tier stream. Real
    # 15 s clips hold < 1024 nonempty runs; queries with more get
    # excess runs DROPPED into n_dropped (never silent) and the api
    # re-runs them through the scalar expansion. 0 = all lanes
    expand_block_runs: int = 1024
    # bounds-first escalation: at indexes this large, most real queries
    # overflow the fast tier, so the fast-tier program is mostly
    # wasted — a bounds-only probe (match/lookup.query_total) reads the EXACT total and the
    # match dispatches straight to the fitting tier. Below this row
    # count the fast-tier-first policy (with the provably-exact early
    # accept) stays, since most queries fit it there. 0 disables
    bounds_probe_min_rows: int = 1 << 25
    # big-index escalation policy (indexes past bounds_probe_min_rows):
    # "decide" — ONE dispatch at the match_capacity tier that also
    #   returns its search bounds; a clamped result is accepted when
    #   provably exact-top-1 (margin > excluded runs, see
    #   decision_escalation above), else ONE fitted-tier re-dispatch
    #   reusing the bounds. Most production-scale packs decide at the
    #   65536 tier, so the median query pays ~one fast dispatch instead
    #   of probe + fitted.
    # "bounds" — the bounds-first policy: exact-total probe, then one
    #   fitting-tier dispatch (full vote counts on every query).
    # "auto" — "decide" when decision_escalation is True, else "bounds".
    escalation_policy: str = "auto"
    # the decided-first dispatch tier (0 = match_capacity). Corpora with
    # longer hyper-common runs (music skew) may decide more at a higher
    # tier: the dropped-run count shrinks with capacity while the
    # dispatch cost grows with it — pick the smallest tier whose
    # measured decide rate clears ~3/4.
    decide_capacity: int = 0
    # self-tuning decide tier: when more than half of the last
    # decide_adapt_window unpinned decided-first dispatches were
    # UNDECIDED (paid the fitted re-dispatch), the engine raises its
    # decide tier one step (never past decide_adapt_max) — a serving
    # process converges to the corpus's optimum without per-deployment
    # tuning. The optimum is corpus-dependent (the 95.3M tone build
    # decides 7/8 at 65536 while the music-skew build's dropped-run
    # counts need a higher tier). 0 disables adaptation.
    decide_adapt_window: int = 64
    decide_adapt_max: int = 524288
    # capacity tiers grow x4 up to this, x2 after: escalated-tier cost
    # is linear in capacity, so finer steps past the knee halve the
    # worst-case overshoot (a 1.35M-row query pays 2M, not 4M) at the
    # price of a few more warmup compiles
    match_tier_fine_from: int = 262144
    # dense-histogram cutoff: past n_songs * delta_range vote bins the
    # dense (n_songs, delta_range) table costs more than the
    # O(match_capacity) sparse/pruned ranks (~1.5 GB/query at 12K
    # songs).  Exposed mainly so tests can force the big-catalog
    # paths on small corpora; every matcher is element-identical.
    sparse_vote_threshold: int = 16_000_000
    # --- matching / results ---
    topn: int = 2                     # TOPN (recognizer.py:68)
    # --- numerics ---
    spectrogram_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.window_size & (self.window_size - 1):
            raise ValueError("window_size must be a power of two")
        if not (0.0 <= self.overlap_ratio < 1.0):
            raise ValueError("overlap_ratio must be in [0, 1)")
        if self.fan_value < 1:
            raise ValueError("fan_value must be >= 1")
        if self.vote_rank not in ("auto", "pruned", "sort", "scan"):
            raise ValueError(
                f"vote_rank {self.vote_rank!r} not in "
                "('auto', 'pruned', 'sort', 'scan')")
        if self.escalation_policy not in ("auto", "decide", "bounds"):
            raise ValueError(
                f"escalation_policy {self.escalation_policy!r} not in "
                "('auto', 'decide', 'bounds')")

    # ---- derived quantities ----
    @property
    def hop(self) -> int:
        """Samples between adjacent STFT frames (wsize - noverlap)."""
        return self.window_size - int(self.window_size * self.overlap_ratio)

    @property
    def n_freqs(self) -> int:
        """One-sided FFT bin count."""
        return self.window_size // 2 + 1

    @property
    def neighborhood_width(self) -> int:
        """Side of the square local-max footprint (21 for the defaults).

        ``iterate_structure(generate_binary_structure(2, 2), n)`` is the
        (2n+1)x(2n+1) full square (reference ``__init__.py:130-137``).
        """
        return 2 * self.peak_neighborhood_size + 1

    def num_frames(self, n_samples: int) -> int:
        """STFT frame count for an n_samples signal (mlab.specgram layout)."""
        if n_samples < self.window_size:
            return 0
        return (n_samples - self.window_size) // self.hop + 1

    def frames_to_seconds(self, offset_frames: float) -> float:
        """Reference ``recognizer.py:318`` offset -> seconds conversion."""
        return round(
            float(offset_frames)
            / self.sample_rate
            * self.window_size
            * self.overlap_ratio,
            5,
        )

    # ---- (de)serialization, mirrors the reference's JSON config dicts ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FingerprintConfig":
        return cls(**json.loads(text))

    def replace(self, **kwargs: Any) -> "FingerprintConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = FingerprintConfig()

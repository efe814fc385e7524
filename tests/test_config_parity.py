"""Oracle parity for NON-reference configs.

The fingerprint pipeline (`ops/fingerprint.py`) is fully parameterized — window
size, hop, peak radius, fan-out, time-delta window, amp threshold,
sample rate — and `FingerprintConfig` invites users to change them
(the reference exposed the same knobs, ``__init__.py:41-51``). Parity
was previously gated only at the reference config; these tests pin the
whole parameter surface against the equally-parameterized oracle so a
custom-config deployment inherits the same correctness contract.
"""

import numpy as np
import pytest

from shazam_tpu.audio.synth import synth_song
from shazam_tpu.config import FingerprintConfig

from .oracle.oracle import oracle_fingerprint

CONFIGS = [
    # smaller window + tighter neighborhood, lower threshold, wide fan
    dict(sample_rate=22050, window_size=2048, peak_neighborhood_size=5,
         amp_min=5.0, fan_value=8),
    # tiny window, narrow fan, higher threshold, shorter pairing window
    dict(sample_rate=44100, window_size=1024, peak_neighborhood_size=3,
         amp_min=15.0, fan_value=3, max_hash_time_delta=100),
    # reference window at 75% overlap (hop 1024) and nonzero min_dt
    dict(sample_rate=44100, window_size=4096, overlap_ratio=0.75,
         peak_neighborhood_size=10, amp_min=10.0, fan_value=5,
         min_hash_time_delta=2),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=["small-win", "tiny-win",
                                             "dense-hop"])
def test_custom_config_matches_oracle(kw):
    from shazam_tpu.ops.fingerprint import (
        fingerprint, fingerprint_to_hex_pairs,
    )

    cfg = FingerprintConfig(**kw)
    clip = np.asarray(
        synth_song(9, duration_s=2.5, fs=cfg.sample_rate, seed=77),
        dtype=np.float32)

    fp = fingerprint(clip, config=cfg)
    assert int(fp.n_peaks) <= cfg.peak_capacity  # no silent overflow
    ours = set(fingerprint_to_hex_pairs(fp))

    ref = set(oracle_fingerprint(
        clip, fs=cfg.sample_rate, wsize=cfg.window_size,
        wratio=cfg.overlap_ratio, fan_value=cfg.fan_value,
        amp_min=cfg.amp_min, neighborhood=cfg.peak_neighborhood_size,
        min_dt=cfg.min_hash_time_delta, max_dt=cfg.max_hash_time_delta,
        reduction=cfg.fingerprint_reduction,
    ))
    assert ref, "oracle produced no hashes — clip/config too sparse to gate"
    inter, union = len(ours & ref), len(ours | ref)
    jaccard = inter / union
    assert jaccard > 0.97, (
        f"jaccard={jaccard:.4f} ({len(ours)} ours vs {len(ref)} oracle) "
        f"for config {kw}")


def test_custom_config_end_to_end_recognition():
    """A catalog built under a custom config still identifies clips
    (the whole API honors the config, not just the DSP core)."""
    from shazam_tpu.api import SIA

    cfg = FingerprintConfig(sample_rate=22050, window_size=2048,
                            peak_neighborhood_size=5, amp_min=5.0,
                            fan_value=8)
    sia = SIA(config=cfg)
    songs = [(f"s{i}", synth_song(i, duration_s=6.0, fs=22050, seed=13))
             for i in range(3)]
    sia.ingest_arrays(songs)
    clip = np.asarray(songs[2][1])[22050: 4 * 22050]
    out = sia.recognize_samples([clip])
    assert out["results"][0]["song_name"] == "s2"

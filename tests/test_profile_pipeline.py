"""The trace-to-stage reduction of benchmarks/profile_pipeline.py, checked
on a small trace recorded here (on the CPU the events live on the host
plane; on the card they live on the GPU planes)."""

import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))


def test_stage_split_from_trace(tmp_path):
    import jax
    import jax.numpy as jnp

    import profile_pipeline as pp
    from shazam_tpu.ops.fingerprint import fingerprint_batch

    x = jnp.asarray(np.random.default_rng(0).normal(
        0, 3000, (2, 1 << 18)).astype(np.float32))
    nv = jnp.asarray([200000, 200000], jnp.int32)
    stage_of = pp.hlo_stage_map(fingerprint_batch.lower(x, nv).compile()
                                .as_text())
    assert set(stage_of.values()) == set(pp.STAGES)
    jax.block_until_ready(fingerprint_batch(x, nv))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(fingerprint_batch(x, nv))
    xplane = sorted(glob.glob(str(tmp_path / "**" / "*.xplane.pb"),
                              recursive=True))[-1]
    per, busy = pp.device_stage_times(xplane, "fingerprint_batch", stage_of,
                                      plane_prefix="/host:CPU")
    assert all(per[s] > 0 for s in pp.STAGES), per
    assert 0 < busy <= sum(per.values())


def test_min_bytes_scale_with_batch():
    import profile_pipeline as pp

    one = pp.min_bytes(1, 1 << 18, 127, 2049, 8192)
    two = pp.min_bytes(2, 1 << 18, 127, 2049, 8192)
    assert set(one) == set(pp.STAGES)
    assert all(two[s] == 2 * one[s] for s in pp.STAGES)

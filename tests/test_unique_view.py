"""Unique-key search table (index/search.UniqueView) parity.

The view collapses duplicate 80-bit keys into one sorted row + a CDF so
the match search is ONE fixed-round descent with a free upper bound.
These tests pin element-identical results vs the bucket-CDF head path
on a heavily duplicated synthetic index (hot runs included) and through
the API end to end.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from shazam_tpu.index.search import (build_head, build_unique_view,
                                     lexi_bounds, unique_bounds)
from shazam_tpu.index.store import FingerprintIndex
from shazam_tpu.match.lookup import match_query, match_query_sparse
from shazam_tpu.match.batched import match_queries_batched


def _dup_index(n=20_000, n_songs=50, seed=3):
    """Sorted index with heavy key duplication + one hot run."""
    rng = np.random.default_rng(seed)
    n_uniq = n // 40                      # ~40 rows per key
    hi = rng.integers(0, 2**32, n_uniq, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n_uniq, dtype=np.uint32)
    ex = rng.integers(0, 2**16, n_uniq, dtype=np.uint32)
    pick = rng.integers(0, n_uniq, n - 2000)
    # a 2000-row hot run on one key
    pick = np.concatenate([pick, np.zeros(2000, np.int64)])
    khi, klo, kex = hi[pick], lo[pick], ex[pick]
    sid = rng.integers(0, n_songs, n, dtype=np.uint32)
    off = rng.integers(0, 3000, n, dtype=np.uint32)
    order = np.lexsort((kex, klo, khi))
    return FingerprintIndex(khi[order], klo[order], kex[order],
                            sid[order], off[order], n_songs, 3000), \
        (hi, lo, ex)


def _queries(uniq, q=512, seed=7):
    rng = np.random.default_rng(seed)
    hi, lo, ex = uniq
    k = q // 2
    qi = rng.integers(0, len(hi), k)
    q_hi = np.concatenate([hi[qi], rng.integers(0, 2**32, q - k,
                                                dtype=np.uint32)])
    q_lo = np.concatenate([lo[qi], rng.integers(0, 2**32, q - k,
                                                dtype=np.uint32)])
    q_ex = np.concatenate([ex[qi], rng.integers(0, 2**16, q - k,
                                                dtype=np.uint32)])
    q_t = rng.integers(0, 300, q).astype(np.uint32)
    q_valid = np.ones(q, bool)
    q_valid[-5:] = False                  # padding lanes
    q_first = np.ones(q, bool)
    return tuple(jnp.asarray(a) for a in
                 (q_hi, q_lo, q_ex, q_t, q_valid, q_first))


@pytest.fixture(scope="module")
def setup():
    index, uniq = _dup_index()
    dev = index.device_arrays()
    head = build_head(dev[0], bits=12)
    uview, usteps = build_unique_view(
        index.key_hi, index.key_lo, index.key_ex)
    assert uview is not None and usteps >= 1
    return index, dev, head, uview, usteps, uniq


def test_bounds_parity(setup):
    index, dev, head, uview, usteps, uniq = setup
    qa = _queries(uniq)
    lb_r, ub_r = jax.device_get(lexi_bounds(
        dev[0], dev[1], dev[2], qa[0], qa[1], qa[2], head=head,
        q_valid=qa[4]))
    lb_u, ub_u = jax.device_get(jax.jit(
        lambda v, *q: unique_bounds(v, *q, steps=usteps))(
        uview, qa[0], qa[1], qa[2], qa[4]))
    valid = np.asarray(qa[4])
    span_r = np.where(valid, ub_r - lb_r, 0)
    span_u = ub_u - lb_u
    assert np.array_equal(span_u, span_r)
    # lb agrees wherever there are rows (misses return 0 by contract)
    hitmask = span_r > 0
    assert np.array_equal(lb_u[hitmask], lb_r[hitmask])


@pytest.mark.parametrize("matcher", [match_query, match_query_sparse])
def test_match_parity(setup, matcher):
    index, dev, head, uview, usteps, uniq = setup
    qa = _queries(uniq)
    kw = dict(n_songs=index.n_songs, delta_min=-512, delta_range=4096,
              match_capacity=32768, topn=3,
              offset_stride=index.offset_stride)
    base = jax.device_get(matcher(dev, *qa, head=head, **kw))
    uv = jax.device_get(matcher(dev, *qa, uview=uview, u_steps=usteps,
                                **kw))
    for a, b in zip(base, uv):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_batched_parity(setup):
    index, dev, head, uview, usteps, uniq = setup
    qs = [_queries(uniq, seed=s) for s in (7, 11)]
    qa = tuple(jnp.stack([q[i] for q in qs]) for i in range(6))
    kw = dict(n_songs=index.n_songs, delta_min=-512, delta_range=4096,
              match_capacity=32768, topn=2,
              offset_stride=index.offset_stride)
    base = jax.device_get(match_queries_batched(dev, *qa, head=head, **kw))
    uv = jax.device_get(match_queries_batched(
        dev, *qa, uview=uview, u_steps=usteps, **kw))
    for a, b in zip(base, uv):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_small_index_skips_view():
    uview, usteps = build_unique_view(
        np.arange(10, dtype=np.uint32), np.zeros(10, np.uint32),
        np.zeros(10, np.uint32))
    assert uview is None and usteps == 0


def test_api_end_to_end_with_view():
    """A catalog big enough to cross HEAD_MIN_ROWS builds the view and
    recognition stays correct (single-dispatch + batch + mutation
    invalidation)."""
    from shazam_tpu.api import SIA
    from shazam_tpu.audio.synth import synth_song

    sia = SIA()
    songs = [(f"t{i}", synth_song(i, duration_s=10.0, seed=11))
             for i in range(12)]
    sia.ingest_arrays(songs)
    assert sia._index.n_hashes >= 4096

    dev = sia._ensure_device_index()
    uview, usteps = sia._ensure_uview(dev)
    assert uview is not None

    clip = songs[4][1][44100: 44100 * 6]
    out = sia.recognize_clip(clip)
    assert out["results"][0]["song_name"] == "t4"

    outs = sia.recognize_batch([songs[2][1][44100: 44100 * 6],
                                songs[9][1][44100: 44100 * 6]])
    assert [o["results"][0]["song_name"] for o in outs] == ["t2", "t9"]

    # mutation invalidates the cached view (new device columns)
    t4_id = next(s["song_id"] for s in sia.catalog.get_songs()
                 if s["song_name"] == "t4")
    sia.delete_songs([t4_id])
    dev2 = sia._ensure_device_index()
    uview2, _ = sia._ensure_uview(dev2)
    assert uview2 is not uview
    out = sia.recognize_clip(songs[9][1][44100: 44100 * 6])
    assert out["results"][0]["song_name"] == "t9"


def test_steps_guard_raises(setup):
    """Passing a view without its build-time round count is a bug, not a
    silent no-match: unique_bounds refuses steps<=0 (a fori_loop of zero
    rounds would leave every lane at its bucket start and match
    nothing, violating the never-silent invariant)."""
    index, dev, head, uview, usteps, uniq = setup
    q = _queries(uniq)
    with pytest.raises(ValueError, match="steps"):
        unique_bounds(uview, q[0], q[1], q[2], q[4], steps=0)


def test_near_unique_at_scale_skips_view():
    """A near-unique key set past the size cutoff declines the view:
    duplicating >128 MB of key columns buys nothing when there are no hot runs for the head
    path's while_loop to trip on."""
    n = (8 << 20) * 2 + 2
    hi = np.arange(n, dtype=np.uint32)          # all keys unique
    zeros = np.zeros(n, np.uint32)
    uview, usteps = build_unique_view(hi, zeros, zeros)
    assert uview is None and usteps == 0

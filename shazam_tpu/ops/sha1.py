"""Bit-exact vectorized SHA-1 for fingerprint hash keys.

The reference hashes the ASCII string ``f"{f1}|{f2}|{dt}"`` with hashlib
SHA-1 and keeps the first 20 hex chars (80 bits) — reference
``__init__.py:179-210`` (``generate_hashes``), ``FINGERPRINT_REDUCTION``
at ``__init__.py:51``.

Those messages are at most 14 bytes (each field <= 4 decimal digits), so
after padding they always occupy exactly one 512-bit SHA-1 block. This
module evaluates the full 80-round SHA-1 compression as lane-parallel
uint32 vector ops (no matrix unit needed), processing millions of
messages per call. The tricky part is that the message *bytes* depend on
the decimal digit counts of f1/f2/dt; the padded block is built by integer
digit decomposition, never strings.

Validated bit-for-bit against hashlib over random (f1, f2, dt) triples in
``tests/test_sha1.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_MASK32 = np.uint32(0xFFFFFFFF)


def _rotl(x: jnp.ndarray, n: int) -> jnp.ndarray:
    return (x << n) | (x >> (32 - n))


def _num_digits(x: jnp.ndarray) -> jnp.ndarray:
    """Decimal digit count for 0 <= x <= 9999 (uint32)."""
    return (
        jnp.uint32(1)
        + (x >= 10).astype(_U32)
        + (x >= 100).astype(_U32)
        + (x >= 1000).astype(_U32)
    )


def _digit_char(x: jnp.ndarray, ndig: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """ASCII code of decimal digit `pos` (MSB-first) of x, given its digit count."""
    # exponent = ndig - 1 - pos in {0,1,2,3}
    e = ndig - jnp.uint32(1) - pos
    div = jnp.where(e == 0, 1, jnp.where(e == 1, 10, jnp.where(e == 2, 100, 1000)))
    return jnp.uint32(0x30) + (x // div.astype(_U32)) % jnp.uint32(10)


_PIPE = np.uint32(0x7C)  # '|'
_MAX_MSG_BYTES = 15      # 4+1+4+1+4 digits/pipes = 14, plus the 0x80 pad byte


def _build_block_words(f1: jnp.ndarray, f2: jnp.ndarray, dt: jnp.ndarray):
    """Pack padded messages "f1|f2|dt" into SHA-1 block words w0..w15.

    All inputs uint32 with values in [0, 9999]. Returns a list of 16
    uint32 arrays (big-endian byte packing per the SHA-1 spec).
    """
    f1 = f1.astype(_U32)
    f2 = f2.astype(_U32)
    dt = dt.astype(_U32)
    d1 = _num_digits(f1)
    d2 = _num_digits(f2)
    d3 = _num_digits(dt)
    pipe1 = d1                     # index of first '|'
    pipe2 = d1 + d2 + jnp.uint32(1)  # index of second '|'
    msg_len = d1 + d2 + d3 + jnp.uint32(2)

    byte_cols = []
    for p in range(_MAX_MSG_BYTES):
        pu = jnp.uint32(p)
        in_f1 = pu < d1
        is_p1 = pu == pipe1
        in_f2 = (pu > pipe1) & (pu < pipe2)
        is_p2 = pu == pipe2
        in_dt = (pu > pipe2) & (pu < msg_len)
        is_pad = pu == msg_len
        # positions within each numeric field (clamped; masked by selects)
        c1 = _digit_char(f1, d1, jnp.minimum(pu, d1 - 1))
        c2 = _digit_char(f2, d2, jnp.minimum(pu - pipe1 - 1, d2 - 1))
        c3 = _digit_char(dt, d3, jnp.minimum(pu - pipe2 - 1, d3 - 1))
        byte = jnp.where(
            in_f1, c1,
            jnp.where(
                is_p1 | is_p2, _PIPE,
                jnp.where(in_f2, c2,
                          jnp.where(in_dt, c3,
                                    jnp.where(is_pad, jnp.uint32(0x80),
                                              jnp.uint32(0)))),
            ),
        )
        byte_cols.append(byte)

    zero = jnp.zeros_like(f1)
    words = []
    for wi in range(16):
        w = zero
        for bi in range(4):
            idx = wi * 4 + bi
            b = byte_cols[idx] if idx < _MAX_MSG_BYTES else zero
            w = (w << 8) | b
        words.append(w)
    # bit length goes in the final 64-bit big-endian field; msg_len < 56 so
    # word 14 stays 0 and word 15 = 8 * msg_len.
    words[15] = msg_len << 3
    return words


_K = np.array([0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6], dtype=np.uint32)


def sha1_triples(f1: jnp.ndarray, f2: jnp.ndarray, dt: jnp.ndarray):
    """SHA-1 of "f1|f2|dt" for arrays of uint32 triples.

    Returns the five 32-bit digest words (h0..h4), each shaped like f1.
    The 80-bit fingerprint key is (h0, h1, h2 >> 16).

    The 80 rounds run as a ``fori_loop`` over 5 blocks of 16 fully
    unrolled rounds: within a block every message-schedule index is
    static (t mod 16 == j), so there is no dynamic slicing in the hot
    loop — each round is ~10 pure lane-parallel vector ops. (A flat
    80-round loop with a circular buffer spends most of its time in
    dynamic_index/update ops; a fully unrolled trace compiles slowly.)
    """
    w0 = _build_block_words(f1, f2, dt)  # list of 16 (N,) words

    a0 = jnp.full_like(w0[0], np.uint32(0x67452301))
    b0 = jnp.full_like(w0[0], np.uint32(0xEFCDAB89))
    c0 = jnp.full_like(w0[0], np.uint32(0x98BADCFE))
    d0 = jnp.full_like(w0[0], np.uint32(0x10325476))
    e0 = jnp.full_like(w0[0], np.uint32(0xC3D2E1F0))
    ks = jnp.asarray(_K)

    def block_fn(blk, carry):
        *w, a, b, c, d, e = carry
        w = list(w)
        for j in range(16):
            t = blk * 16 + j  # traced scalar; w indices below are static
            # schedule: for t < 16 (blk 0) w[j] is the message word
            # itself and the recurrence would corrupt it — the
            # jnp.where select keeps the original word on block 0
            # (data select, not control flow: blk is traced)
            wt_sched = _rotl(
                w[(j + 13) % 16] ^ w[(j + 8) % 16]
                ^ w[(j + 2) % 16] ^ w[j],
                1,
            )
            wt = jnp.where(blk == 0, w[j], wt_sched)
            w[j] = wt
            # regime select without control flow (a lax.switch per round
            # costs far more than the round's vector work in branch
            # overhead)
            regime = t // 20
            f_parity = b ^ c ^ d
            f_choose = (b & c) | (jnp.invert(b) & d)
            f_major = (b & c) | (b & d) | (c & d)
            f = jnp.where(
                regime == 0, f_choose,
                jnp.where(regime == 2, f_major, f_parity),
            )
            k = ks[regime]
            tmp = _rotl(a, 5) + f + e + k + wt
            a, b, c, d, e = tmp, a, _rotl(b, 30), c, d
        return (*w, a, b, c, d, e)

    out = jax.lax.fori_loop(0, 5, block_fn, (*w0, a0, b0, c0, d0, e0))
    a, b, c, d, e = out[16:]
    return a0 + a, b0 + b, c0 + c, d0 + d, e0 + e


@functools.partial(jax.jit, static_argnames=())
def sha1_fingerprint_keys(f1: jnp.ndarray, f2: jnp.ndarray, dt: jnp.ndarray):
    """80-bit truncated fingerprint keys as (hi, lo, ex16) uint32 triples.

    hi = digest bits 0..31, lo = bits 32..63, ex16 = bits 64..79 (the
    first 4 hex chars of the third digest word). Together these are the
    first FINGERPRINT_REDUCTION=20 hex chars of the sha1 hexdigest.
    """
    h0, h1, h2, _h3, _h4 = sha1_triples(f1, f2, dt)
    return h0, h1, h2 >> 16


def keys_to_hex(hi: np.ndarray, lo: np.ndarray, ex: np.ndarray):
    """Host-side: render (hi, lo, ex16) keys as the reference's 20-char hex."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    ex = np.asarray(ex, dtype=np.uint32)
    return [f"{a:08x}{b:08x}{c:04x}" for a, b, c in zip(hi.ravel(), lo.ravel(), ex.ravel())]

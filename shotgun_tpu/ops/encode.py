"""Numeric k-mer encoding shared by host (numpy) and device (jax.numpy).

A k-mer (k <= 31) is 2-bit packed into a (lo, hi) uint32 pair, so every
hot op stays in 32-bit integers without enabling ``jax_enable_x64``
process-wide.  The hash used for table placement is a two-word
xorshift-multiply mix; host table *build* and device *probe* must agree
bit-for-bit, so both call these functions with their array module.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

# splitmix64-derived odd constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F
_GOLDEN = 0x9E3779B9


def mix32(lo, hi, xp=np):
    """Hash a (lo, hi) uint32 pair to a uint32 bucket index basis."""
    u = xp.uint32
    h = (lo ^ u(_GOLDEN)) * u(_C1)
    h = h ^ (h >> u(15))
    h = (h ^ (hi * u(_C2))) * u(_C3)
    h = h ^ (h >> u(13))
    h = h * u(_C1)
    h = h ^ (h >> u(16))
    return h


def rolling_encode_jnp(codes: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[B, L] uint8 base codes -> ([B, W], [B, W]) uint32 k-mer (lo, hi).

    Window w covers codes[:, w:w+k]; W = L - k + 1.  Pad/N positions produce
    garbage values that callers must mask out via validity masks.
    """
    b, l = codes.shape
    w = l - k + 1
    assert w >= 1, "batch length must be >= k"
    lo = jnp.zeros((b, w), dtype=jnp.uint32)
    hi = jnp.zeros((b, w), dtype=jnp.uint32)
    for j in range(k):
        c = codes[:, j: j + w].astype(jnp.uint32)
        hi = (hi << jnp.uint32(2)) | (lo >> jnp.uint32(30))
        lo = (lo << jnp.uint32(2)) | (c & jnp.uint32(3))
    return lo, hi


def unpack_codes_2bit(packed: jnp.ndarray) -> jnp.ndarray:
    """[B, L/4] uint8 (4 bases/byte, little bit-pairs) -> [B, L] uint8.

    Reads contain no N (the FASTQ parser rejects it, reference
    records.py:262), so 2-bit packing is lossless and cuts the
    host->device codes transfer 4x.  The unpack is a handful of shifts
    inside the jit.
    """
    b, p = packed.shape
    u = packed.astype(jnp.uint32)[:, :, None]
    shifts = jnp.arange(4, dtype=jnp.uint32)[None, None, :] * jnp.uint32(2)
    return ((u >> shifts) & jnp.uint32(3)).astype(jnp.uint8).reshape(b, 4 * p)


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side inverse of ``unpack_codes_2bit`` ([B, L] u8, L % 4 == 0)."""
    c = codes.reshape(codes.shape[0], -1, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2)
            | (c[:, :, 2] << 4) | (c[:, :, 3] << 6))


def rolling_encode_words_jnp(codes: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, ...]:
    """[B, L] uint8 base codes -> tuple of [B, W] uint32 key words,
    MOST-significant first (ready to use as ``lax.sort`` key operands).

    Any k.  Bit layout matches the host ``index.build.rolling_encode_words``
    exactly (little-word column j there == tuple element nw-1-j here).
    For k <= 31 this is (hi, lo) from the tuned 2-word encoder.  For
    larger k each word is a contiguous 16-base (top word: k mod 16) pack:
    one shared pass builds the 16-base pack array and full words are
    slices of it, so the work is O(16 + k mod 16) shift steps, not O(k*nw).
    """
    if k <= 31:
        lo, hi = rolling_encode_jnp(codes, k)
        return (hi, lo)
    b, l = codes.shape
    w = l - k + 1
    assert w >= 1, "batch length must be >= k"
    nw = max(2, -(-k // 16))
    c32 = codes.astype(jnp.uint32) & jnp.uint32(3)
    npk = l - 15
    p16 = jnp.zeros((b, npk), dtype=jnp.uint32)
    for s in range(16):
        p16 = (p16 << jnp.uint32(2)) | c32[:, s: s + npk]
    out = []
    for j in range(nw):  # little-word index: bases t in [k-16(j+1), k-16j)
        t_hi = k - 16 * j
        t_lo = max(t_hi - 16, 0)
        if t_hi - t_lo == 16:
            wj = p16[:, t_lo: t_lo + w]
        else:
            wj = jnp.zeros((b, w), dtype=jnp.uint32)
            for s in range(t_hi - t_lo):
                wj = (wj << jnp.uint32(2)) | c32[:, t_lo + s: t_lo + s + w]
        out.append(wj)
    return tuple(out[::-1])


def window_quality_sums(qual: jnp.ndarray, k: int) -> jnp.ndarray:
    """[B, L] uint8 raw quality bytes -> [B, W] int32 window sums.

    Integer sums let quality gates run as exact integer comparisons
    (`sum < threshold * k`) instead of replicating Python float division
    (reference kmer.py:401-408 computes mean-of-ord; comparing sums is
    algebraically identical for integer thresholds)."""
    b, l = qual.shape
    w = l - k + 1
    cs = jnp.cumsum(qual.astype(jnp.int32), axis=1)
    zeros = jnp.zeros((b, 1), dtype=jnp.int32)
    cs = jnp.concatenate([zeros, cs], axis=1)  # [B, L+1]
    return cs[:, k: k + w] - cs[:, 0:w]

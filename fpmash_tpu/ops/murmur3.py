"""Batched MurmurHash3_x64_128 on device.

Batched reimplementation of the reference's hashing layer
(mash/src/mash/MurmurHash3.cpp via hash.cpp:12-73): instead of hashing one
k-mer / one fingerprint line at a time on a CPU thread, whole batches are
hashed as uint64 lane arithmetic under ``jit`` — rotates, xors and 64-bit
multiplies vectorize, and the sequential dimension (16-byte blocks) is a
``lax.scan`` of length ``ceil(L/2)`` only.

Variable lengths are handled with per-row masking: rows are zero-padded,
full blocks are applied only while ``block < n_blocks(row)``, and the odd
tail (always exactly one u64 for fingerprint vectors, 1-15 bytes for byte
strings) is folded in afterwards.  Zero padding is semantics-preserving for
the tail because MurmurHash3's tail mixes bytes with XOR/OR only.

Validated bit-for-bit against :mod:`fpmash_tpu.scalar.murmur3`, which is
validated against the reference goldens.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# NumPy scalars, not jnp: a jnp constant created while a trace is active
# (this module may first be imported inside a jit) would be a tracer of
# that trace and leak into every later use
_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_M5 = np.uint64(5)
_A1 = np.uint64(0x52DCE729)
_A2 = np.uint64(0x38495AB5)


def _rotl64(x, r: int):
    return (x << jnp.uint64(r)) | (x >> jnp.uint64(64 - r))


def _fmix64(k):
    k = k ^ (k >> jnp.uint64(33))
    k = k * _F1
    k = k ^ (k >> jnp.uint64(33))
    k = k * _F2
    return k ^ (k >> jnp.uint64(33))


def _mix_k1(k1):
    return _rotl64(k1 * _C1, 31) * _C2


def _mix_k2(k2):
    return _rotl64(k2 * _C2, 33) * _C1


def _block_update(h1, h2, k1, k2):
    h1 = h1 ^ _mix_k1(k1)
    h1 = _rotl64(h1, 27) + h2
    h1 = h1 * _M5 + _A1
    h2 = h2 ^ _mix_k2(k2)
    h2 = _rotl64(h2, 31) + h1
    h2 = h2 * _M5 + _A2
    return h1, h2


def _finalize(h1, h2, byte_len):
    h1 = h1 ^ byte_len
    h2 = h2 ^ byte_len
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2


@partial(jax.jit, static_argnames=("seed",))
def murmur3_u64_batch(vals: jax.Array, counts: jax.Array, seed: int = 42):
    """Hash each row of ``vals[B, L]`` (uint64) over its first ``counts[b]``
    elements, as the little-endian byte image of the vector.

    This is the fingerprint hashing unit (hash.cpp:45-73): one fingerprint
    line of ``n`` factor lengths hashes ``n*8`` bytes.  Returns ``(h1, h2)``
    uint64 arrays of shape ``[B]``; the sketch keeps ``h1`` (low 64 bits of
    the digest) or its low 32 bits.

    ``vals`` must be zero-padded beyond ``counts`` (enforced here by
    masking).  L is padded to even internally.
    """
    vals = vals.astype(jnp.uint64)
    counts = counts.astype(jnp.int32)
    B, L = vals.shape

    # Zero out padding lanes so the tail load is clean.
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    vals = jnp.where(lane < counts[:, None], vals, jnp.uint64(0))

    if L % 2:
        vals = jnp.pad(vals, ((0, 0), (0, 1)))
        L += 1

    nblocks = counts // 2  # full 16-byte blocks per row
    seed64 = jnp.uint64(seed)
    h1 = jnp.full((B,), seed64)
    h2 = jnp.full((B,), seed64)

    # Iterate block pairs only up to the *batch's* maximum block count —
    # fingerprint vectors are short (a handful of Lyndon factors per
    # window), so this typically runs a few iterations instead of L/2.
    pairs = vals.reshape(B, L // 2, 2).transpose(1, 2, 0)  # [L/2, 2, B]
    max_blocks = jnp.max(nblocks)

    UNROLL = 2  # blocks per loop iteration (masked, so over-stepping is safe)

    def cond(state):
        h1, h2, i = state
        return i < max_blocks

    def body(state):
        h1, h2, i = state
        for u in range(UNROLL):
            xs = jax.lax.dynamic_index_in_dim(
                pairs, jnp.minimum(i + u, L // 2 - 1), axis=0, keepdims=False
            )
            n1, n2 = _block_update(h1, h2, xs[0], xs[1])
            full = (i + u) < nblocks
            h1 = jnp.where(full, n1, h1)
            h2 = jnp.where(full, n2, h2)
        return (h1, h2, i + UNROLL)

    h1, h2, _ = jax.lax.while_loop(cond, body, (h1, h2, jnp.int32(0)))

    # Odd tail: exactly one u64 (8 bytes), mixed into k1 only.
    has_tail = (counts % 2) == 1
    tail_idx = jnp.maximum(counts - 1, 0)
    k1t = jnp.take_along_axis(vals, tail_idx[:, None].astype(jnp.int32), axis=1)[:, 0]
    h1 = jnp.where(has_tail, h1 ^ _mix_k1(k1t), h1)

    byte_len = (counts.astype(jnp.uint64)) * jnp.uint64(8)
    return _finalize(h1, h2, byte_len)


def _pack_u64(data: jax.Array):
    """Pack zero-padded u8[B, W*8] into little-endian u64[B, W]."""
    B, L = data.shape
    assert L % 8 == 0
    words = data.reshape(B, L // 8, 8).astype(jnp.uint64)
    shifts = (jnp.arange(8, dtype=jnp.uint64) * jnp.uint64(8))[None, None, :]
    return jnp.sum(words << shifts, axis=-1, dtype=jnp.uint64)


@partial(jax.jit, static_argnames=("seed",))
def murmur3_bytes_batch(data: jax.Array, lengths: jax.Array, seed: int = 42):
    """Hash each row of ``data[B, L]`` (uint8) over its first ``lengths[b]``
    bytes — the classic k-mer hashing unit (hash.cpp:12-40).

    Returns ``(h1, h2)`` uint64 ``[B]``.  Rows are masked internally, so
    padding content is irrelevant.  For fixed-k k-mer batches ``lengths``
    is a constant array and the single block + tail unrolls completely.
    """
    data = data.astype(jnp.uint8)
    lengths = lengths.astype(jnp.int32)
    B, L = data.shape

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    data = jnp.where(pos < lengths[:, None], data, jnp.uint8(0))

    pad = (-L) % 16
    if pad:
        data = jnp.pad(data, ((0, 0), (0, pad)))
        L += pad

    words = _pack_u64(data)  # [B, L/8]
    nblocks = lengths // 16
    tail_len = lengths % 16

    seed64 = jnp.uint64(seed)
    h1 = jnp.full((B,), seed64)
    h2 = jnp.full((B,), seed64)

    pairs = words.reshape(B, L // 16, 2).transpose(1, 2, 0)  # [L/16, 2, B]

    def step(carry, xs):
        h1, h2, i = carry
        n1, n2 = _block_update(h1, h2, xs[0], xs[1])
        full = i < nblocks
        h1 = jnp.where(full, n1, h1)
        h2 = jnp.where(full, n2, h2)
        return (h1, h2, i + 1), None

    (h1, h2, _), _ = jax.lax.scan(step, (h1, h2, jnp.int32(0)), pairs)

    # Tail: words at [2*nblocks] and [2*nblocks+1] (zero-padded already).
    widx = jnp.minimum((nblocks * 2).astype(jnp.int32), L // 8 - 1)
    k1t = jnp.take_along_axis(words, widx[:, None], axis=1)[:, 0]
    k2t = jnp.take_along_axis(
        words, jnp.minimum(widx + 1, L // 8 - 1)[:, None], axis=1
    )[:, 0]
    # Mask the k1 tail word down to tail_len bytes and k2 to tail_len-8.
    def _mask_word(w, nbytes):
        nbits = jnp.clip(nbytes, 0, 8).astype(jnp.uint64) * jnp.uint64(8)
        full = nbits >= jnp.uint64(64)
        mask = jnp.where(full, ~jnp.uint64(0), (jnp.uint64(1) << nbits) - jnp.uint64(1))
        return w & mask

    k1t = _mask_word(k1t, tail_len)
    k2t = _mask_word(k2t, tail_len - 8)
    h2 = jnp.where(tail_len > 8, h2 ^ _mix_k2(k2t), h2)
    h1 = jnp.where(tail_len > 0, h1 ^ _mix_k1(k1t), h1)

    return _finalize(h1, h2, lengths.astype(jnp.uint64))


def to_hash(h1: jax.Array, use64: bool) -> jax.Array:
    """Keep low 64 or low 32 bits of the digest (Sketch.cpp:1288 rule)."""
    return h1 if use64 else (h1 & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)

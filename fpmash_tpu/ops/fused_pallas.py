"""Fused fingerprint kernel for the GPU: Duval (CFL) + MurmurHash3 per window.

The ``sketch --direct-fp`` hot path is: shift window -> CFL factor lengths
-> MurmurHash3_x64_128 of the u64 length vector (lyn2vec
factorizations.py:102 -> fingerprint line -> getHashFingerPrint,
hash.cpp:45-73).  The plain XLA pipeline
(``ops.lyndon.cfl_lengths_onehot`` + ``ops.murmur3.murmur3_u64_batch``)
reads each automaton character with a one-hot reduction over the whole
row and writes a ``[B, L]`` factor-length matrix to device memory.

This Pallas kernel (``backend="triton"``) runs one window per lane:

* a program owns :data:`BLOCK` = 32 windows and runs on one warp, so the
  automaton loop exits at the granularity of one warp's divergence;
* characters are read by per-lane indexed loads from the flat byte
  stream the host uploaded (each read once, not one row per window: shift
  windows overlap ~100x), which stays in L1;
* phase 1 runs the Duval automaton and records each factor START as one
  bit of a ``ceil(L/32)``-word per-lane register bitmask; phase 2 walks
  the set bits two at a time and feeds each pair of factor lengths into
  one MurmurHash3 block — factor lengths never reach device memory;
* the hash state is native 64-bit arithmetic in registers.  It is kept
  in ``int64`` (wrapping add/mul/xor/shift are sign-agnostic; right
  shifts are logical) because the Triton lowering cannot encode u64
  constants above 2**63.

Semantics are identical to the XLA pipeline; both are asserted against
the scalar chain (``scalar.lyndon.cfl`` + ``scalar.murmur3``) in tests,
the kernel in interpret mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: windows per program (one per lane of a single warp)
BLOCK = 32

#: widest window the kernel takes (its bitmask is ceil(L/32) registers)
MAX_L = 512

#: automaton steps per loop iteration (over-stepping a finished window is
#: a masked no-op, so this only amortizes the loop's exit test)
UNROLL = 4


def _s64(c: int) -> int:
    """u64 constant -> the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_C1 = _s64(0x87C37B91114253D5)
_C2 = _s64(0x4CF5AD432745937F)
_F1 = _s64(0xFF51AFD7ED558CCD)
_F2 = _s64(0xC4CEB9FE1A85EC53)


def _srl(x, r: int):
    return jax.lax.shift_right_logical(x, jnp.int64(r))


def _rotl(x, r: int):
    return (x << jnp.int64(r)) | _srl(x, 64 - r)


def _fmix(k):
    k = k ^ _srl(k, 33)
    k = k * jnp.int64(_F1)
    k = k ^ _srl(k, 33)
    k = k * jnp.int64(_F2)
    return k ^ _srl(k, 33)


def _mix_k1(k1):
    return _rotl(k1 * jnp.int64(_C1), 31) * jnp.int64(_C2)


def _mix_k2(k2):
    return _rotl(k2 * jnp.int64(_C2), 33) * jnp.int64(_C1)


def _ctz(word):
    """Index of the lowest set bit of a nonzero i32 vector."""
    return jax.lax.population_count((word & -word) - 1)


def _kernel(L: int, seed: int, stream_ref, start_ref, len_ref, h_ref, cnt_ref):
    M = -(-L // 32)  # boundary-bitmask words per window
    last = stream_ref.shape[0] - 1
    st = start_ref[...]
    n = len_ref[...]
    zeros = jnp.zeros_like(n)

    def sel(col):
        # per-lane indexed load; columns clip into the window (reads past a
        # row's length are never compared) and the index into the stream
        idx = jnp.minimum(st + jnp.clip(col, 0, L - 1), last)
        return stream_ref[idx].astype(jnp.int32)

    # ---- phase 1: Duval automaton, factor starts as bits ----
    def substep(state):
        i, j, k, em, cnt, ms = state
        emitting = em > 0
        s_k = sel(k)
        s_j = sel(j)
        done = i >= n
        can_extend = (j < n) & (s_k <= s_j)
        k_scan = jnp.where(s_k < s_j, i, k + 1)
        p = j - k
        emit_now = i <= k
        fire = emitting & ~done & emit_now
        bit = jnp.int32(1) << (i & 31)
        iw = i >> 5
        ms = tuple(
            jnp.where(fire & (iw == w), ms[w] | bit, ms[w]) for w in range(M)
        )
        cnt = cnt + fire.astype(jnp.int32)
        i_emit = jnp.where(emit_now, i + p, i)
        j_emit = jnp.where(emit_now, j, i + 1)
        k_emit = jnp.where(emit_now, k, i)
        scanning = ~emitting & ~done
        i = jnp.where(scanning | done, i, i_emit)
        j = jnp.where(
            scanning, jnp.where(can_extend, j + 1, j), jnp.where(done, j, j_emit)
        )
        k = jnp.where(
            scanning, jnp.where(can_extend, k_scan, k), jnp.where(done, k, k_emit)
        )
        em = jnp.where(
            scanning,
            (~can_extend).astype(jnp.int32),
            jnp.where(done, em, emit_now.astype(jnp.int32)),
        )
        return i, j, k, em, cnt, ms

    def alive(x, bound):
        return jnp.max(jnp.where(x < bound, jnp.int32(1), jnp.int32(0))) > 0

    def body1(state):
        for _ in range(UNROLL):
            state = substep(state)
        return state

    init = (zeros, zeros + 1, zeros, zeros, zeros, (zeros,) * M)
    _, _, _, _, cnt, ms = jax.lax.while_loop(
        lambda s: alive(s[0], n), body1, init
    )

    # ---- phase 2: boundary bits -> factor lengths -> murmur blocks ----
    ms = (ms[0] & ~1,) + ms[1:]  # the first factor starts at 0

    def next_start(ms, prev):
        """(next factor start or n, bitmask with that bit cleared)."""
        nz = [m != 0 for m in ms]
        word, base = ms[M - 1], jnp.full_like(n, (M - 1) * 32)
        for w in range(M - 2, -1, -1):
            word = jnp.where(nz[w], ms[w], word)
            base = jnp.where(nz[w], w * 32, base)
        anyb = nz[0]
        for w in range(1, M):
            anyb = anyb | nz[w]
        nxt = jnp.where(anyb, base + _ctz(word), n)
        cleared = word & (word - 1)
        out, before = [], jnp.zeros(n.shape, jnp.bool_)
        for w in range(M):
            out.append(jnp.where(~before & nz[w], cleared, ms[w]))
            before = before | nz[w]
        return nxt, tuple(out), nxt - prev

    seedv = jnp.full(n.shape, seed, jnp.int64)

    def body2(state):
        f, prev, h1, h2, ms = state
        prev, ms, a = next_start(ms, prev)
        prev, ms, b = next_start(ms, prev)
        k1 = a.astype(jnp.int64)
        k2 = b.astype(jnp.int64)
        pair = f + 2 <= cnt
        tail = f + 1 == cnt
        n1 = _rotl(h1 ^ _mix_k1(k1), 27) + h2
        n1 = n1 * jnp.int64(5) + jnp.int64(0x52DCE729)
        n2 = _rotl(h2 ^ _mix_k2(k2), 31) + n1
        n2 = n2 * jnp.int64(5) + jnp.int64(0x38495AB5)
        h1 = jnp.where(pair, n1, jnp.where(tail, h1 ^ _mix_k1(k1), h1))
        h2 = jnp.where(pair, n2, h2)
        return f + 2, prev, h1, h2, ms

    _, _, h1, h2, _ = jax.lax.while_loop(
        lambda s: alive(s[0], cnt), body2, (zeros, zeros, seedv, seedv, ms)
    )

    # finalize (byte length = 8 bytes per factor)
    byte_len = cnt.astype(jnp.int64) << jnp.int64(3)
    h1 = h1 ^ byte_len
    h2 = h2 ^ byte_len
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h_ref[...] = h1 + h2
    cnt_ref[...] = cnt


@partial(jax.jit, static_argnames=("L", "seed", "interpret"))
def fingerprint_hashes_stream(
    stream: jax.Array,  # u8[N] window bytes (reads uploaded once)
    starts: jax.Array,  # i32[B] window start offsets into ``stream``
    lengths: jax.Array,  # i32[B] window lengths (<= L)
    *,
    L: int,
    seed: int = 42,
    interpret: bool = False,
):
    """``(h1 u64[B], fac_count i32[B])``: MurmurHash3_x64_128 (low 64 bits)
    of each window's CFL factor-length vector, and its factor count.

    Window ``b`` is ``stream[starts[b] : starts[b] + lengths[b]]``; bytes
    compare as unsigned values, so any alphabet works.  ``L`` (static, at
    most :data:`MAX_L`) bounds every window's length.
    """
    if not 1 <= L <= MAX_L:
        raise ValueError(f"window width {L} outside 1..{MAX_L}")
    B = starts.shape[0]
    Bp = -(-B // BLOCK) * BLOCK
    st = jnp.zeros((Bp,), jnp.int32).at[:B].set(starts.astype(jnp.int32))
    ln = jnp.zeros((Bp,), jnp.int32).at[:B].set(lengths.astype(jnp.int32))
    blk = pl.BlockSpec((BLOCK,), lambda b: (b,))
    h, cnt = pl.pallas_call(
        partial(_kernel, L, seed),
        out_shape=(
            jax.ShapeDtypeStruct((Bp,), jnp.int64),
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
        ),
        grid=(Bp // BLOCK,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), blk, blk],
        out_specs=(blk, blk),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="cfl_murmur_fused",
    )(stream.astype(jnp.uint8), st, ln)
    return jax.lax.bitcast_convert_type(h[:B], jnp.uint64), cnt[:B]

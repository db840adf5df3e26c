"""Batched Duval (CFL) factorization on device.

The reference computes one Duval factorization per shift window, serially,
inside a fork pool (lyn2vec factorizations.py:102, driven by lyn2vec.py:40).
Here the whole batch of windows ``[B, L]`` runs as ONE ``lax.scan`` whose
state advances every row's Duval state machine a step per iteration —
sequential in at most ``4L`` steps, data-parallel over B lanes.

Duval's algorithm is restated as a 2-phase per-row automaton:

* phase SCAN: extend the candidate prefix — compare ``s[k]`` vs ``s[j]``;
  on ``<`` reset ``k=i``, on ``==`` advance ``k``, both advance ``j``;
  exit to EMIT when ``j == n`` or ``s[k] > s[j]``.
* phase EMIT: the period is ``p = j - k``; emit one factor length ``p`` and
  advance ``i += p`` while ``i <= k``; then reset ``j = i+1, k = i`` and
  return to SCAN (or finish when ``i >= n``).

Step bound: SCAN steps total ≤ 2n (classic Duval analysis), EMIT steps ≤ n
factors, phase transitions ≤ n, so ``4L`` iterations always suffice.

Output is the factor-length list per row, which is exactly the fingerprint
(and what the sketch hashes), so factor *strings* never need to leave the
device on the hot path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=())
def cfl_lengths(batch: jax.Array, lengths: jax.Array):
    """Duval factor lengths for each row of ``batch[B, L]`` (uint8).

    ``lengths[b]`` is the valid prefix length of row ``b``.  Returns
    ``(fac_len[B, L] int32, fac_count[B] int32)`` where row ``b``'s factor
    lengths are ``fac_len[b, :fac_count[b]]`` (zero beyond).
    """
    batch = batch.astype(jnp.uint8)
    n = lengths.astype(jnp.int32)
    B, L = batch.shape
    steps = 4 * L + 2

    def gather(col):
        # per-row element batch[b, col[b]], clamped for safety
        c = jnp.clip(col, 0, L - 1)
        return jnp.take_along_axis(batch, c[:, None], axis=1)[:, 0]

    def step(state, _):
        i, j, k, emitting, out_idx, out = state

        s_k = gather(k)
        s_j = gather(j)

        done = i >= n

        # ---- SCAN transition (valid when not emitting, not done) ----
        can_extend = (j < n) & (s_k <= s_j)
        k_scan = jnp.where(s_k < s_j, i, k + 1)
        # when can't extend, switch to EMIT with i,j,k unchanged

        # ---- EMIT transition (valid when emitting) ----
        p = j - k
        emit_now = i <= k  # emit one factor of length p
        out_scan_idx = jnp.where(emit_now & emitting & ~done, out_idx, L)
        out = out.at[jnp.arange(B), jnp.clip(out_scan_idx, 0, L)].set(
            jnp.where(out_scan_idx < L, p, 0), mode="drop"
        )

        i_emit = jnp.where(emit_now, i + p, i)
        # after last repetition, reset scan pointers
        reset = ~emit_now
        j_emit = jnp.where(reset, i + 1, j)
        k_emit = jnp.where(reset, i, k)
        emitting_next_e = jnp.where(reset, False, True)

        # ---- select per phase ----
        scanning = ~emitting & ~done
        i_next = jnp.where(scanning, i, jnp.where(done, i, i_emit))
        j_next = jnp.where(scanning, jnp.where(can_extend, j + 1, j), jnp.where(done, j, j_emit))
        k_next = jnp.where(scanning, jnp.where(can_extend, k_scan, k), jnp.where(done, k, k_emit))
        emitting_next = jnp.where(
            scanning, ~can_extend, jnp.where(done, emitting, emitting_next_e)
        )
        out_idx_next = jnp.where(emitting & emit_now & ~done, out_idx + 1, out_idx)

        return (i_next, j_next, k_next, emitting_next, out_idx_next, out), None

    zeros = jnp.zeros((B,), jnp.int32)
    init = (
        zeros,  # i
        zeros + 1,  # j
        zeros,  # k
        jnp.zeros((B,), bool),  # emitting: start in SCAN
        zeros,  # out_idx
        jnp.zeros((B, L + 1), jnp.int32),  # out (slot L = spill for drops)
    )
    (i, _, _, _, out_idx, out), _ = jax.lax.scan(step, init, None, length=steps)
    return out[:, :L], out_idx


@partial(jax.jit, static_argnames=())
def cfl_lengths_sa(batch: jax.Array, lengths: jax.Array):
    """Duval factor lengths via suffix ranks — a loop-free formulation.

    Uses the classical characterization: the CFL factor start positions of
    ``w`` are exactly the left-to-right *strict minima* of the suffix
    order (the last factor is the lexicographically smallest suffix, and
    recursively each factor starts where a new smallest suffix begins).
    Suffix ranks are computed by prefix doubling — ``ceil(log2 L)`` rounds
    of per-row argsort/re-rank on ``[B, L]`` arrays — so the whole batch
    factorizes in O(log² L) *parallel* steps of regular vector work
    instead of the O(L) sequential scan with per-step gathers in
    :func:`cfl_lengths`.  Verified equivalent to the scan kernel and the
    scalar model in tests.

    Returns ``(fac_len[B, L] int32, fac_count[B] int32)`` like
    :func:`cfl_lengths`.
    """
    batch = batch.astype(jnp.int32)
    n = lengths.astype(jnp.int32)
    B, L = batch.shape

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_row = pos < n[:, None]
    # sentinel 0 beyond the row length makes fixed-length comparison equal
    # to finite-suffix lexicographic comparison (no real byte is 0)
    s = jnp.where(in_row, batch, 0)

    rank = s
    k = 1
    while k < L:
        # rank of the suffix starting k later (or -1 past the end)
        rank_k = jnp.concatenate(
            [rank[:, k:], jnp.full((B, k), -1, jnp.int32)], axis=1
        )
        key = rank.astype(jnp.int64) * jnp.int64(1 << 32) + (rank_k.astype(jnp.int64) + 1)
        order = jnp.argsort(key, axis=-1)
        sorted_key = jnp.take_along_axis(key, order, axis=-1)
        bumps = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             (sorted_key[:, 1:] != sorted_key[:, :-1]).astype(jnp.int32)],
            axis=1,
        )
        new_rank_sorted = jnp.cumsum(bumps, axis=-1)
        inv = jnp.argsort(order, axis=-1)
        rank = jnp.take_along_axis(new_rank_sorted, inv, axis=-1)
        k *= 2

    # boundaries = strict running minima of the suffix rank
    masked = jnp.where(in_row, rank, L + 1)
    cmin = jax.lax.cummin(masked, axis=1)
    first = jnp.concatenate([jnp.ones((B, 1), bool), cmin[:, 1:] < cmin[:, :-1]], axis=1)
    boundary = first & in_row

    # compact boundary positions to the left; factor length = gap to next
    bpos = jnp.where(boundary, pos, L)
    bpos = jnp.sort(bpos, axis=-1)
    nxt = jnp.concatenate([bpos[:, 1:], jnp.full((B, 1), L, jnp.int32)], axis=1)
    fac_len = jnp.minimum(nxt, n[:, None]) - jnp.minimum(bpos, n[:, None])
    fac_len = jnp.maximum(fac_len, 0)
    fac_count = jnp.sum(boundary, axis=-1, dtype=jnp.int32)
    return fac_len, fac_count


@partial(jax.jit, static_argnames=())
def cfl_boundary_mask(batch: jax.Array, lengths: jax.Array) -> jax.Array:
    """Duval factor-start positions as a ``bool[B, L]`` mask.

    The mask form composes: the CFL_ICFL and *_COMB factorization families
    are unions of boundary masks (see :mod:`fpmash_tpu.ops.factorize`).
    """
    L = batch.shape[1]
    n = lengths.astype(jnp.int32)
    return unpack_boundary_words(_cfl_boundary_words(batch, n), n)[:, :L]


def cfl_lengths_onehot(batch: jax.Array, lengths: jax.Array):
    """Duval scan with explicit one-hot gathers — the XLA route of the
    CFL fingerprint step (the GPU runs the fused Triton kernel instead).

    Same automaton as :func:`cfl_lengths`, but engineered for memory
    traffic and vector shape:

    * per-row dynamic reads ``s[k]``/``s[j]`` are masked reductions over
      a 4-chars-per-u32 packed copy of the batch (no XLA gather ops, and
      the loop-invariant string traffic shrinks 4x);
    * factor boundaries accumulate into a *packed* ``u32[L/32]`` bitmask
      per row — the per-step state is tiny instead of a [B, L] mask;
    * the loop is a ``while_loop`` that exits as soon as every row's
      automaton has finished (typical inputs need ~1.5n steps; the bound
      is 3n: scan comparisons <= 2n, emissions <= n, and transitions fold
      into the first emission step).

    Factor lengths then fall out of the unpacked mask with one sort (as in
    :func:`cfl_lengths_sa`).
    """
    n = lengths.astype(jnp.int32)
    L = batch.shape[1]
    words = _cfl_boundary_words(batch, n)
    boundary = unpack_boundary_words(words, n)[:, :L]
    return lengths_from_boundary(boundary, n)


cfl_lengths_onehot = jax.jit(cfl_lengths_onehot)


def _cfl_boundary_words(batch: jax.Array, n: jax.Array) -> jax.Array:
    """Core Duval automaton; returns packed ``u32[B, ceil(L/32)]`` boundary
    bits (factor starts)."""
    B, L = batch.shape
    W = (L + 31) // 32  # boundary words
    max_steps = 3 * L + 2

    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_row = iota < n[:, None]
    wiota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)

    # pack 4 chars per u32 word: per-step selection reduces over L/4 lanes
    # instead of L, cutting the dominant loop-invariant traffic 4x
    CW = (L + 3) // 4
    padded = jnp.pad(batch.astype(jnp.uint32), ((0, 0), (0, CW * 4 - L)))
    shifts = (jnp.arange(4, dtype=jnp.uint32) * jnp.uint32(8))[None, None, :]
    packed = jnp.sum(padded.reshape(B, CW, 4) << shifts, axis=-1, dtype=jnp.uint32)
    ciota = jax.lax.broadcasted_iota(jnp.int32, (B, CW), 1)

    def sel(col):
        word = jnp.sum(
            jnp.where(ciota == (col[:, None] >> 2), packed, jnp.uint32(0)),
            axis=1,
            dtype=jnp.uint32,
        )
        sh = (col.astype(jnp.uint32) & jnp.uint32(3)) * jnp.uint32(8)
        return ((word >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)

    # Automaton steps are applied UNROLL at a time inside each while
    # iteration: a step is a masked state transition (finished rows are
    # no-ops), so over-stepping is harmless, and the loop's fixed per-
    # iteration sequencing overhead — which dominates at these tiny state
    # sizes — is amortized UNROLL-fold.
    UNROLL = 8

    def substep(state):
        i, j, k, emitting, words = state
        s_k = sel(k)
        s_j = sel(jnp.minimum(j, L - 1))
        done = i >= n

        can_extend = (j < n) & (s_k <= s_j)
        k_scan = jnp.where(s_k < s_j, i, k + 1)

        p = j - k
        emit_now = i <= k
        do_mark = emitting & ~done & emit_now
        mark_word = wiota == (i[:, None] >> 5)
        bit = (jnp.uint32(1) << (i.astype(jnp.uint32) & jnp.uint32(31)))[:, None]
        words = jnp.where(do_mark[:, None] & mark_word, words | bit, words)

        i_emit = jnp.where(emit_now, i + p, i)
        reset = ~emit_now
        j_emit = jnp.where(reset, i + 1, j)
        k_emit = jnp.where(reset, i, k)

        scanning = ~emitting & ~done
        i_next = jnp.where(scanning | done, i, i_emit)
        j_next = jnp.where(scanning, jnp.where(can_extend, j + 1, j), jnp.where(done, j, j_emit))
        k_next = jnp.where(scanning, jnp.where(can_extend, k_scan, k), jnp.where(done, k, k_emit))
        emitting_next = jnp.where(scanning, ~can_extend, jnp.where(done, emitting, emit_now))
        return (i_next, j_next, k_next, emitting_next, words)

    def cond(state):
        t, i, j, k, emitting, words = state
        return (t < max_steps) & jnp.any(i < n)

    def body(state):
        t, i, j, k, emitting, words = state
        inner = (i, j, k, emitting, words)
        for _ in range(UNROLL):
            inner = substep(inner)
        i, j, k, emitting, words = inner
        return (t + UNROLL, i, j, k, emitting, words)

    zeros = jnp.zeros((B,), jnp.int32)
    init = (
        jnp.int32(0),
        zeros,
        zeros + 1,
        zeros,
        jnp.zeros((B,), bool),
        jnp.zeros((B, W), jnp.uint32),
    )
    _, _, _, _, _, words = jax.lax.while_loop(cond, body, init)
    return words


def unpack_boundary_words(words: jax.Array, n: jax.Array) -> jax.Array:
    """``u32[B, ceil(L/32)]`` packed boundary bits -> ``bool[B, L]`` mask
    (masked to each row's valid length)."""
    B, W = words.shape
    L = W * 32
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    word_of = jnp.repeat(words, 32, axis=1)
    boundary = ((word_of >> (iota.astype(jnp.uint32) & jnp.uint32(31))) & jnp.uint32(1)) > 0
    return boundary & (iota < n[:, None])


def lengths_from_boundary(boundary: jax.Array, n: jax.Array):
    """Factor-start ``bool[B, Lb]`` mask -> ``(fac_len[B, Lb], fac_count[B])``.

    Factor lengths are the gaps between consecutive set bits (compacted to
    the left with one sort), clipped to the row length — the shared epilogue
    of every boundary-producing factorization kernel.
    """
    B, L = boundary.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    boundary = boundary & (iota < n[:, None])
    bpos = jnp.where(boundary, iota, L)
    bpos = jnp.sort(bpos, axis=-1)
    nxt = jnp.concatenate([bpos[:, 1:], jnp.full((B, 1), L, jnp.int32)], axis=1)
    fac_len = jnp.maximum(jnp.minimum(nxt, n[:, None]) - jnp.minimum(bpos, n[:, None]), 0)
    fac_count = jnp.sum(boundary, axis=-1, dtype=jnp.int32)
    return fac_len, fac_count


@partial(jax.jit, static_argnames=())
def cfl_lengths_cmp(batch: jax.Array, lengths: jax.Array):
    """Duval boundaries as one dense shift-compare pass — no sequential loop.

    Uses the same suffix characterization as :func:`cfl_lengths_sa`
    (a CFL factor starts at ``p`` iff suffix ``p`` is lexicographically
    smaller than every suffix starting before it), but resolves all the
    suffix comparisons directly instead of building ranks:

    * ``cmp[d, j] = sign(s[j-d] - s[j])`` for every shift ``d`` — built
      from ``L`` statically-shifted copies of the (0-sentinel-padded) row;
    * ``suffix_p < suffix_{p-d}`` iff the first ``j >= p`` with
      ``cmp[d, j] != 0`` has ``cmp > 0``.  The "first mismatch sign" is
      one reversed ``cummin`` over ``2*j + (cmp > 0)`` (smaller ``j``
      wins; the parity of the min is the sign at the first mismatch);
    * ``boundary[p] = AND over 1 <= d <= p`` — a plain reduction.

    Everything is dense, regular, gather-free elementwise work on
    ``[B, L, L+1]`` tiles — the formulation trades O(L) extra FLOPs per
    base for the removal of the ``while_loop``'s per-step dispatch and
    its serial latency, which is what actually bounds
    :func:`cfl_lengths_onehot` on small windows.
    """
    n = lengths.astype(jnp.int32)
    B, L = batch.shape
    LP = L + 1  # one sentinel column so end-of-row mismatches stay in range

    iota_row = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_row = iota_row < n[:, None]
    s = jnp.where(in_row, batch.astype(jnp.int16), 0)
    s = jnp.pad(s, ((0, 0), (0, 1)))  # [B, LP], trailing sentinel

    # Sd[b, d, j] = s[b, j - d] (zero-filled), d = 0..L-1
    Sd = jnp.stack(
        [jnp.pad(s[:, : LP - d], ((0, 0), (d, 0))) for d in range(L)], axis=1
    )  # [B, L, LP]
    cmp = Sd - s[:, None, :]  # sign: >0 -> s[j-d] > s[j]

    jiota = jax.lax.broadcasted_iota(jnp.int32, (B, L, LP), 2)
    BIG = jnp.int32(2 * LP + 2)
    val = jnp.where(cmp != 0, 2 * jiota + (cmp > 0), BIG)
    first = jax.lax.cummin(val, axis=2, reverse=True)  # first mismatch from j
    less = (first & 1) == 1  # sign at first mismatch > 0 => suffix_p smaller

    diota = jax.lax.broadcasted_iota(jnp.int32, (B, L, L), 1)
    piota = jax.lax.broadcasted_iota(jnp.int32, (B, L, L), 2)
    consider = (diota >= 1) & (diota <= piota)
    ok = less[:, :, :L] | ~consider
    boundary = jnp.all(ok, axis=1) & in_row

    bpos = jnp.where(boundary, iota_row, L)
    bpos = jnp.sort(bpos, axis=-1)
    nxt = jnp.concatenate([bpos[:, 1:], jnp.full((B, 1), L, jnp.int32)], axis=1)
    fac_len = jnp.maximum(jnp.minimum(nxt, n[:, None]) - jnp.minimum(bpos, n[:, None]), 0)
    fac_count = jnp.sum(boundary, axis=-1, dtype=jnp.int32)
    return fac_len, fac_count


@partial(jax.jit, static_argnames=("L",))
def windows_from_stream(stream, starts, lengths, *, L: int):
    """``u8[B, L]`` window rows gathered on device from a flat byte stream:
    row ``b`` is ``stream[starts[b] : starts[b] + lengths[b]]``, zero past
    its length (the layout every ``[B, L]`` kernel here takes).  Callers
    pad ``stream`` so that ``starts + L`` stays in range."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (starts.shape[0], L), 1)
    rows = stream[starts.astype(jnp.int32)[:, None] + iota]
    return jnp.where(iota < lengths.astype(jnp.int32)[:, None], rows, jnp.uint8(0))


def encode_batch(windows, dtype=np.uint8):
    """Host helper: list of strings -> (u8[B, L] zero-padded, lengths[B])."""
    B = len(windows)
    L = max((len(w) for w in windows), default=1)
    arr = np.zeros((B, max(L, 1)), dtype=dtype)
    lens = np.zeros((B,), dtype=np.int32)
    for r, w in enumerate(windows):
        b = w.encode("ascii") if isinstance(w, str) else bytes(w)
        arr[r, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[r] = len(b)
    return arr, lens


def cfl_lengths_host(windows, kernel: str = "onehot") -> list[list[int]]:
    """Factor-length lists for a batch of strings via the device kernel."""
    arr, lens = encode_batch(windows)
    fn = {
        "sa": cfl_lengths_sa,
        "onehot": cfl_lengths_onehot,
        "scan": cfl_lengths,
        "cmp": cfl_lengths_cmp,
    }[kernel]
    fac_len, fac_count = jax.device_get(fn(jnp.asarray(arr), jnp.asarray(lens)))
    return [list(map(int, fac_len[b, : fac_count[b]])) for b in range(len(windows))]


def cfl_factor_strings(windows) -> list[list[str]]:
    """Factor strings (sliced on host from the device-computed lengths)."""
    out = []
    for w, lens in zip(windows, cfl_lengths_host(windows)):
        factors = []
        pos = 0
        for n in lens:
            factors.append(w[pos : pos + n])
            pos += n
        out.append(factors)
    return out

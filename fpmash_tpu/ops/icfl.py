"""Batched inverse-Lyndon (ICFL) factorization on device.

The reference computes ICFL with a per-string Python recursion
(lyn2vec/factorizations.py:143-248: ``find_pre`` ascent scan, ``find_bre``
bounded right extension via a KMP failure pass, and a post-hoc merge) —
~3 Mbases/s on one host core.  Here the whole ``[B, L]`` batch advances as
ONE ``lax.while_loop`` whose step applies every row's automaton transition
in parallel, the same architecture as the batched Duval kernel
(:mod:`fpmash_tpu.ops.lyndon`).

The automaton restates the recursion with two observations that remove the
explicit KMP pass (both proved via the pre-necklace structure and verified
against the scalar model on 10^5+ fuzz cases):

* During the ascent scan (the anti-order Duval scan ``w[j] <= w[i]``), the
  matched-prefix counter ``i`` at position ``j`` IS the longest proper
  border of ``w[:j]`` — prefixes scanned by Duval are pre-necklaces, whose
  smallest period is ``j - i``.  Recording ``st[j] = i`` per position makes
  the failure function's border *chain* available with no second pass.
* The reference's bounded-right-extension walk
  (factorizations_comb.py:82-102) computes
  ``last = min{ b in borderchain(x[:-1]) : w[b] < c } `` where ``c`` is the
  ascent character; the chain is exactly ``st[jx], st[st[jx]], ...`` and
  its head ``st[jx]`` always qualifies (the scan exited *because*
  ``c > w[i]``), so the walk needs only ``st``.

Per segment level ``m`` the automaton then peels ``p = w[:jx - best]``,
records ``(boundary_pos, p_len, last=best)``, and rescans the bounded right
extension — mirroring the reference's recursion ``w = bre + y``.  The final
merge (``ICFL_recursive``'s "insert or prepend" fold over the recursion
stack) runs as ONE backward ``lax.scan`` over the recorded levels: level
``m`` contributes a factor boundary at ``base_m + p_len_m`` iff the
running first-factor length exceeds ``last_m``.

Everything returns *boundary masks* (``bool[B, L]`` factor-start bits),
which is what makes the whole factorization family compositional:

* ``CFL_ICFL-T``  = CFL mask  |  ICFL run inside each CFL factor > T
  (markers ``<<``/``>>`` never materialize: fingerprints strip them before
  emitting lengths, fingerprint_utils.py:461-465);
* ``*_COMB``      = fwd mask  |  position-flipped mask of the
  reverse complement (the two-list refinement merge of
  factorizations_comb.py:213-246 *is* the union of cut positions).

Segments: the kernel processes, per row, an ordered list of disjoint
``(start, len)`` segments — one whole-row segment for plain ICFL, the >T
factors for CFL_ICFL — sequentially with the same state machine.

Capacity: levels are recorded into ``LV`` slots per row.  Rows that
overflow ``LV`` or exhaust the step bound report ``ok=False`` (callers
fall back to the scalar model for those rows); random and adversarial DNA
tops out at ~19 levels per 100 bases, so LV=64 makes the fallback
essentially unreachable.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fpmash_tpu.ops.lyndon import lengths_from_boundary, unpack_boundary_words

# Level-record packing: bpos | plen | last in 10-bit fields + marker bit.
_F = 10  # field width: positions/lengths < 1024 (we gate L <= 1023)
_MARKER = np.uint32(1 << 30)  # NumPy: no jnp work at import

SCAN, CHAIN, ROWDONE = 0, 1, 2


@partial(jax.jit, static_argnames=("lv", "unroll"))
def icfl_boundary_words(
    batch: jax.Array,
    lengths: jax.Array,
    seg_start: jax.Array,
    seg_len: jax.Array,
    nseg: jax.Array,
    lv: int = 32,
    unroll: int = 8,
):
    """Run the ICFL automaton over per-row segment lists.

    Args:
      batch: ``u8[B, L]`` zero-padded rows.
      lengths: ``i32[B]`` valid prefix length per row.
      seg_start/seg_len: ``i32[B, S]`` disjoint, ascending segments to
        factorize (entries beyond ``nseg[b]`` ignored).  Segments of
        length < 2 are legal (they emit only their marker).
      nseg: ``i32[B]`` number of valid segments per row.
      lv: static level-record capacity per row.

    Returns:
      ``(words u32[B, ceil(L/32)], ok bool[B])`` — factor-start bits
      *within* segments, excluding each segment's own start bit (callers
      own segment starts: bit 0 for plain ICFL, the CFL mask for CFL_ICFL).
    """
    B, L = batch.shape
    if L >= (1 << _F):
        raise ValueError(f"row width {L} exceeds the {_F}-bit level packing")
    n = lengths.astype(jnp.int32)
    W = (L + 31) // 32
    # step bound: scan+chain steps are amortized <~2 per consumed base
    # (measured max 1.82), plus one commit step per level/marker
    max_steps = 4 * L + 2 * lv + 16

    wiota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)

    # chars packed 4-per-u32 (loop-invariant traffic cut 4x, as in Duval)
    CW = (L + 3) // 4
    padded = jnp.pad(batch.astype(jnp.uint32), ((0, 0), (0, CW * 4 - L)))
    shifts = (jnp.arange(4, dtype=jnp.uint32) * jnp.uint32(8))[None, None, :]
    packed = jnp.sum(padded.reshape(B, CW, 4) << shifts, axis=-1, dtype=jnp.uint32)
    ciota = jax.lax.broadcasted_iota(jnp.int32, (B, CW), 1)

    def sel(col):
        col = jnp.clip(col, 0, L - 1)
        word = jnp.sum(
            jnp.where(ciota == (col[:, None] >> 2), packed, jnp.uint32(0)),
            axis=1,
            dtype=jnp.uint32,
        )
        sh = (col.astype(jnp.uint32) & jnp.uint32(3)) * jnp.uint32(8)
        return ((word >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)

    # st[] (longest-border-so-far per relative position): values < L, so
    # pack 4 x 8-bit when L <= 256 (halves the dominant per-step RMW
    # traffic), else 2 x 16-bit
    if L <= 256:
        st_per, st_shift_bits, st_mask = 4, 3, jnp.uint32(0xFF)
        st_idx_shift, st_lane_mask = 2, jnp.uint32(3)
    else:
        st_per, st_shift_bits, st_mask = 2, 4, jnp.uint32(0xFFFF)
        st_idx_shift, st_lane_mask = 1, jnp.uint32(1)
    SW = (L + st_per - 1) // st_per
    siota = jax.lax.broadcasted_iota(jnp.int32, (B, SW), 1)

    def st_read(st, pos):
        pos = jnp.clip(pos, 0, L - 1)
        word = jnp.sum(
            jnp.where(siota == (pos[:, None] >> st_idx_shift), st, jnp.uint32(0)),
            axis=1,
            dtype=jnp.uint32,
        )
        sh = (pos.astype(jnp.uint32) & st_lane_mask) << st_shift_bits
        return ((word >> sh) & st_mask).astype(jnp.int32)

    def st_write(st, pos, val, enable):
        pos = jnp.clip(pos, 0, L - 1)
        tgt = siota == (pos[:, None] >> st_idx_shift)
        sh = (((pos.astype(jnp.uint32) & st_lane_mask)) << st_shift_bits)[:, None]
        keep = ~(st_mask << sh)
        new = (st & keep) | (val.astype(jnp.uint32)[:, None] << sh)
        return jnp.where(enable[:, None] & tgt, new, st)

    liota = jax.lax.broadcasted_iota(jnp.int32, (B, lv), 1)
    S = seg_start.shape[1]
    giota = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)

    def seg_get(arr, idx):
        return jnp.sum(
            jnp.where(giota == jnp.clip(idx, 0, S - 1)[:, None], arr, 0),
            axis=1,
            dtype=jnp.int32,
        )

    def lev_commit(lev, nlev, ok, value, enable):
        tgt = liota == nlev[:, None]
        lev = jnp.where((enable & (nlev < lv))[:, None] & tgt, value[:, None], lev)
        overflow = enable & (nlev >= lv)
        return lev, jnp.where(enable, nlev + 1, nlev), ok & ~overflow

    def substep(state):
        (phase, seg_idx, base, seg_n, i, j, jx, c, b, best, st, lev, nlev, ok) = state

        scanning = phase == SCAN
        chaining = phase == CHAIN

        s_i = sel(base + i)
        s_j = sel(base + j)

        # ---------- SCAN ----------
        seg_end = j >= seg_n  # segment exhausted: remainder is a factor
        ascent = scanning & ~seg_end & (s_j > s_i)
        # record st[j] = i (longest border of w[:j]) for the chain walk
        st = st_write(st, j, i, scanning & ~seg_end)
        i_scan = jnp.where(s_j == s_i, i + 1, 0)

        # segment-finished bookkeeping (marker level: plen=seg_n, bit30)
        finish = scanning & seg_end
        marker_val = (
            base.astype(jnp.uint32)
            | (seg_n.astype(jnp.uint32) << _F)
            | _MARKER
        )
        seg_idx_f = seg_idx + 1
        row_done = finish & (seg_idx_f >= nseg)
        base_f = seg_get(seg_start, seg_idx_f)
        segn_f = seg_get(seg_len, seg_idx_f)

        # ---------- CHAIN ----------
        commit = chaining & (b <= 0)
        walk = chaining & (b > 0)
        b2 = st_read(st, b)
        s_b2 = sel(base + b2)
        best_w = jnp.where(walk & (s_b2 < c), b2, best)
        # level commit: factor p of length jx-best peeled at base
        p_len = jx - best
        lev_val = (
            (base + p_len).astype(jnp.uint32)
            | (p_len.astype(jnp.uint32) << _F)
            | (best.astype(jnp.uint32) << (2 * _F))
        )
        # finish and commit are mutually exclusive (SCAN vs CHAIN), so one
        # masked pass over the level array serves both records
        lev, nlev, ok = lev_commit(
            lev, nlev, ok, jnp.where(finish, marker_val, lev_val), finish | commit
        )

        # ---------- next state ----------
        phase_n = jnp.where(
            row_done,
            ROWDONE,
            jnp.where(
                finish | commit,
                SCAN,
                jnp.where(ascent, CHAIN, phase),
            ),
        )
        base_n = jnp.where(finish, jnp.where(row_done, base, base_f),
                           jnp.where(commit, base + p_len, base))
        segn_n = jnp.where(finish, jnp.where(row_done, seg_n, segn_f),
                           jnp.where(commit, seg_n - p_len, seg_n))
        restart = (finish & ~row_done) | commit
        i_n = jnp.where(restart, 0, jnp.where(scanning & ~seg_end & ~ascent, i_scan, i))
        j_n = jnp.where(restart, 1, jnp.where(scanning & ~seg_end & ~ascent, j + 1, j))
        jx_n = jnp.where(ascent, j, jx)
        c_n = jnp.where(ascent, s_j, c)
        b_n = jnp.where(ascent, i, jnp.where(walk, b2, b))
        best_n = jnp.where(ascent, i, best_w)
        seg_idx_n = jnp.where(finish, seg_idx_f, seg_idx)
        return (phase_n, seg_idx_n, base_n, segn_n, i_n, j_n, jx_n, c_n, b_n,
                best_n, st, lev, nlev, ok)

    def cond(state):
        t = state[0]
        phase = state[1][0]
        return (t < max_steps) & jnp.any(phase != ROWDONE)

    def body(state):
        t, inner = state
        for _ in range(unroll):
            inner = substep(inner)
        return (t + unroll, inner)

    zeros = jnp.zeros((B,), jnp.int32)
    base0 = seg_get(seg_start, zeros)
    segn0 = seg_get(seg_len, zeros)
    init_inner = (
        jnp.where(nseg > 0, SCAN, ROWDONE).astype(jnp.int32),  # phase
        zeros,  # seg_idx
        base0,
        segn0,
        zeros,  # i
        zeros + 1,  # j
        zeros,  # jx
        zeros,  # c
        zeros,  # b
        zeros,  # best
        jnp.zeros((B, SW), jnp.uint32),  # st
        jnp.zeros((B, lv), jnp.uint32),  # lev
        zeros,  # nlev
        jnp.ones((B,), bool),  # ok
    )
    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), init_inner))
    phase, lev, nlev, ok = final[0], final[11], final[12], final[13]
    ok = ok & (phase == ROWDONE)

    # ---------- merge: backward fold over recorded levels ----------
    # state: (cur_len = length of the current FIRST factor of the merged
    # suffix factorization, boundary words); a marker level resets cur_len
    # to its segment's remainder; a real level inserts a boundary at bpos
    # iff cur_len > last (ICFL_recursive's stack fold).
    mask_f = jnp.uint32((1 << _F) - 1)

    def merge_step(carry, lev_col):
        cur_len, words = carry
        m, val = lev_col
        valid = m < nlev
        is_marker = (val & _MARKER) > 0
        bpos = (val & mask_f).astype(jnp.int32)
        plen = ((val >> _F) & mask_f).astype(jnp.int32)
        last = ((val >> (2 * _F)) & mask_f).astype(jnp.int32)
        insert = valid & ~is_marker & (cur_len > last)
        tgt = wiota == (bpos[:, None] >> 5)
        bit = (jnp.uint32(1) << (bpos.astype(jnp.uint32) & jnp.uint32(31)))[:, None]
        words = jnp.where(insert[:, None] & tgt, words | bit, words)
        cur_len = jnp.where(
            valid,
            jnp.where(is_marker, plen, jnp.where(insert, plen, plen + cur_len)),
            cur_len,
        )
        return (cur_len, words), None

    ms = jnp.arange(lv - 1, -1, -1, dtype=jnp.int32)
    (_, words), _ = jax.lax.scan(
        merge_step,
        (zeros, jnp.zeros((B, W), jnp.uint32)),
        (jnp.broadcast_to(ms[:, None], (lv, B)), lev[:, ::-1].T),
    )
    return words, ok


@partial(jax.jit, static_argnames=())
def icfl_boundary_mask(batch: jax.Array, lengths: jax.Array):
    """Plain ICFL factor-start mask: one whole-row segment per row.

    Returns ``(mask bool[B, L], ok bool[B])``.
    """
    B, L = batch.shape
    n = lengths.astype(jnp.int32)
    words, ok = icfl_boundary_words(
        batch, n, n[:, None] * 0, n[:, None], (n > 0).astype(jnp.int32)
    )
    mask = unpack_boundary_words(words, n)[:, :L]
    # the factorization starts at 0 (segment starts are the caller's)
    mask = mask.at[:, 0].set(n > 0)
    return mask, ok


@partial(jax.jit, static_argnames=("threshold",))
def cfl_icfl_boundary_mask(batch: jax.Array, lengths: jax.Array, threshold: int = 30):
    """CFL_ICFL-T mask: Duval factors longer than T are sub-factorized with
    ICFL in place (factorizations.py:265-301; the ``<<``/``>>`` markers are
    length-transparent).  Returns ``(mask bool[B, L], ok bool[B])``.
    """
    from fpmash_tpu.ops.lyndon import cfl_boundary_mask

    B, L = batch.shape
    n = lengths.astype(jnp.int32)
    cfl_mask = cfl_boundary_mask(batch, n)

    # derive the >T factor segments from the CFL mask
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    bpos = jnp.sort(jnp.where(cfl_mask, iota, L), axis=-1)
    nxt = jnp.concatenate([bpos[:, 1:], jnp.full((B, 1), L, jnp.int32)], axis=1)
    flen = jnp.maximum(jnp.minimum(nxt, n[:, None]) - jnp.minimum(bpos, n[:, None]), 0)
    long = flen > threshold
    # compact long segments to the left; S is a static bound on their count
    S = max(1, L // (threshold + 1))
    order = jnp.argsort(jnp.where(long, iota, L), axis=-1)[:, :S]
    seg_start = jnp.take_along_axis(jnp.where(long, bpos, 0), order, axis=1)
    seg_len = jnp.take_along_axis(jnp.where(long, flen, 0), order, axis=1)
    nseg = jnp.sum(long, axis=-1, dtype=jnp.int32)

    words, ok = icfl_boundary_words(batch, n, seg_start, seg_len, nseg)
    mask = unpack_boundary_words(words, n)[:, :L]
    return cfl_mask | mask, ok

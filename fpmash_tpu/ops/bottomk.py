"""Bottom-k distinct MinHash selection.

Replaces the reference's ``MinHashHeap`` (mash/src/mash/MinHashHeap.cpp):
keep the ``s`` smallest *distinct* hash values, with multiplicity counts,
admitting a hash only once its multiplicity reaches ``multiplicity_minimum``
(reads mode ``-m``; the optional bloom filter is an approximation of
``-m 2`` and is modelled exactly here instead).

The heap's streaming semantics are order-independent for a fixed input
multiset (the final content is exactly "the s smallest distinct hashes with
multiplicity >= m, with their counts"), so the batch equivalent is
sort -> run-length -> filter -> take-first-s.  This equivalence is asserted
against a literal heap model in the tests.

Also provides the estimators backing reads-mode adaptive stopping
(MinHashHeap.h:44-45): ``estimate_set_size = 2^bits * s / max_hash`` and
``estimate_multiplicity = multiplicity_sum / |heap|``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # NumPy: no jnp work at import


def _sort_planes_flat(hi, lo, payload=None):
    """Full ascending sort of a flat (hi, lo) u32-pair array, optionally
    carrying a u32 ``payload`` plane through the permutation.

    Sorts [R, 1024] rows batched and merges pairs of sorted rows with a
    bitonic MERGE network (ascending ++ descending reshaped min/max —
    the same trick as ops/compare.py).  The candidate sort of the
    threshold bottom-k; whether it beats a flat two-key ``lax.sort`` on
    the GPU is not measured yet.  Shapes not divisible into [R, 1024]
    rows fall back to the flat sort.
    """
    n = hi.shape[0]
    C0 = 1024
    if n <= C0 or n % C0:
        if payload is None:
            return jax.lax.sort((hi, lo), num_keys=2)
        return jax.lax.sort((hi, lo, payload), num_keys=2)
    R = n // C0
    h2 = hi.reshape(R, C0)
    l2 = lo.reshape(R, C0)
    if payload is None:
        p2 = None
        h2, l2 = jax.lax.sort((h2, l2), dimension=1, num_keys=2)
    else:
        p2 = payload.reshape(R, C0)
        h2, l2, p2 = jax.lax.sort((h2, l2, p2), dimension=1, num_keys=2)
    while h2.shape[0] > 1:
        if h2.shape[0] % 2:
            pad_h = jnp.full((1, h2.shape[1]), jnp.uint32(0xFFFFFFFF))
            h2 = jnp.concatenate([h2, pad_h])
            l2 = jnp.concatenate([l2, pad_h])
            if p2 is not None:
                p2 = jnp.concatenate([p2, jnp.zeros_like(pad_h)])
        L = h2.shape[1]
        h2 = jnp.concatenate([h2[0::2], h2[1::2][:, ::-1]], axis=1)
        l2 = jnp.concatenate([l2[0::2], l2[1::2][:, ::-1]], axis=1)
        if p2 is not None:
            p2 = jnp.concatenate([p2[0::2], p2[1::2][:, ::-1]], axis=1)
        n2 = 2 * L
        d = L
        while d >= 1:
            hy = h2.reshape(-1, n2 // (2 * d), 2, d)
            ly = l2.reshape(-1, n2 // (2 * d), 2, d)
            ah, bh = hy[:, :, 0, :], hy[:, :, 1, :]
            al, bl = ly[:, :, 0, :], ly[:, :, 1, :]
            swap = (bh < ah) | ((bh == ah) & (bl < al))
            h2 = jnp.stack(
                [jnp.where(swap, bh, ah), jnp.where(swap, ah, bh)], axis=2
            ).reshape(-1, n2)
            l2 = jnp.stack(
                [jnp.where(swap, bl, al), jnp.where(swap, al, bl)], axis=2
            ).reshape(-1, n2)
            if p2 is not None:
                py = p2.reshape(-1, n2 // (2 * d), 2, d)
                ap, bp = py[:, :, 0, :], py[:, :, 1, :]
                p2 = jnp.stack(
                    [jnp.where(swap, bp, ap), jnp.where(swap, ap, bp)],
                    axis=2,
                ).reshape(-1, n2)
            d //= 2
    if p2 is None:
        return h2.reshape(-1)[:n], l2.reshape(-1)[:n]
    return h2.reshape(-1)[:n], l2.reshape(-1)[:n], p2.reshape(-1)[:n]


def _staged_sum_i64(x) -> jax.Array:
    """Exact i64 count of a bool[N] mask WITHOUT an int64-wide vector
    pass: row-partial i32 sums (each <= 1024, no overflow) reduce the
    i64-wide work to N/1024 elements."""
    n = x.shape[0]
    if n % 1024 == 0 and n > 1024:
        partial = jnp.sum(x.reshape(-1, 1024).astype(jnp.int32), axis=1)
        return jnp.sum(partial.astype(jnp.int64))
    return jnp.sum(x.astype(jnp.int64))


def _group_extract_planes(lo: jax.Array, hi: jax.Array, group: int, T: int):
    """Per contiguous group of ``group`` lanes, extract the ``T`` smallest
    DISTINCT (hi, lo) u32-pair values by iterated min-extraction (a pair
    of reduces + a mask per step — no sort).  The (U32MAX, U32MAX) pad
    convention flows through: exhausted groups emit pads.

    Value-duplicates WITHIN a group collapse to one slot (the extraction
    masks every occurrence of the extracted value), so this compaction is
    only valid on the ``need_counts=False, min_cov=1`` path — the
    downstream distinct-dedup collapses them anyway.

    Returns ``(clo, chi, overflow)`` with shapes ``[N // group * T]``;
    ``overflow`` is True iff any group held MORE than T distinct
    survivors (exact check: un-extracted non-pad lanes remain), in which
    case some survivors were dropped and the caller must not trust the
    result.
    """
    U32MAX = jnp.uint32(0xFFFFFFFF)
    N = lo.shape[0]
    M = N // group
    # groups are COLUMNS of a [group, M] view (strided partitions — any
    # fixed partition works for selection): the min-reduce then runs over
    # the MAJOR axis, i.e. pure elementwise ops over contiguous rows
    h2 = hi.reshape(group, M)
    l2 = lo.reshape(group, M)
    outs_hi = []
    outs_lo = []
    for _ in range(T):
        mh = jnp.min(h2, axis=0)
        is_mh = h2 == mh[None, :]
        ml = jnp.min(jnp.where(is_mh, l2, U32MAX), axis=0)
        outs_hi.append(mh)
        outs_lo.append(ml)
        ext = is_mh & (l2 == ml[None, :])
        h2 = jnp.where(ext, U32MAX, h2)
        l2 = jnp.where(ext, U32MAX, l2)
    overflow = jnp.any(~((h2 == U32MAX) & (l2 == U32MAX)))
    chi = jnp.stack(outs_hi, axis=0).reshape(T * M)
    clo = jnp.stack(outs_lo, axis=0).reshape(T * M)
    return clo, chi, overflow


#: group-extraction schedule: two rounds of per-group top-T.  Round 1
#: compacts 64 -> 8 (survivor density 8*s*boost/N keeps per-group
#: overflow probability negligible); round 2 sees 8x the density, so it
#: keeps 16 of 64.  Net 32x volume reduction before the candidate sort.
_COMPACT_ROUNDS = ((64, 8), (64, 16))


def _compact_supported(N: int, s: int, boost: int, min_cov: int,
                       need_counts: bool) -> bool:
    """Whether the XLA group-extraction compaction is VALID for these
    parameters (correctness gate for the explicit ``compact=True``
    override).

    It is never the default (an XLA-side compaction re-streams the
    pool through device memory, and the row sort was faster where it
    was last measured); it stays available, tested, as an explicit
    override.

    Overflow margins for validity: survivor density is d = 8*s*boost/N
    per lane, so round 1 sees Poisson(64*d) distinct survivors per group
    and round 2 Poisson(512*d).  N >= 2048*s*boost bounds those at
    0.25 / 2.0 (per-group overflow ~1e-9 / ~1e-10); the exact overflow
    check catches the exceptions and the caller falls back.
    """
    vol = 1
    for g, t in _COMPACT_ROUNDS:
        if N % (vol * g):
            return False
        vol *= g // t
    return (
        not need_counts
        and min_cov == 1
        and boost <= 2
        and N >= 2048 * s * boost
        and N // vol >= 4096
    )


def _bottom_k_compact_tail(lo, hi, all_taken, *, s: int, boost: int):
    """Candidate compaction + selection for the counts-free path: two
    group-extraction rounds -> flat sort of the ~N/32 candidates -> dedup
    -> first-s selection over a bounded prefix.  Same return contract as
    :func:`bottom_k_premasked_planes` (counts are 1-filled)."""
    U32MAX = jnp.uint32(0xFFFFFFFF)
    clo, chi = lo, hi
    overflow = jnp.bool_(False)
    for g, t in _COMPACT_ROUNDS:
        clo, chi, ov = _group_extract_planes(clo, chi, g, t)
        overflow = overflow | ov
    chi, clo = _sort_planes_flat(chi, clo)
    # survivors sort to the front (pads are U32MAX): the selection only
    # needs a prefix large enough for every survivor incl. duplicates —
    # 32*s*boost is 4x the expected 8*s*boost survivor count, checked
    # exactly below
    cap = min(chi.shape[0], max(4096, 32 * s * boost))
    n_nonpad = _staged_sum_i64(~((chi == U32MAX) & (clo == U32MAX)))
    chi = chi[:cap]
    clo = clo[:cap]
    neq = (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])
    is_boundary = jnp.concatenate([jnp.array([True]), neq])
    eligible = is_boundary & ~((chi == U32MAX) & (clo == U32MAX))
    n_eligible = jnp.sum(eligible.astype(jnp.int32))

    values, counts, n = _select_first_s(chi, clo, eligible, None, s)
    ok = (
        ~overflow
        & (n_nonpad <= cap)
        & ((n_eligible >= s) | all_taken)
    )
    return values, counts, n, ok


def _run_counts_sorted(is_boundary, is_start, cap: int):
    """Run lengths at run starts of a SORTED candidate array, via
    log-step suffix-min of the boundary indices (in place of a
    ``lax.cummin``; whether that matters on the GPU is ROADMAP D3)."""
    idx_arr = jnp.arange(cap, dtype=jnp.int32)
    # nxt[i] = smallest boundary index > i (cap when none)
    x = jnp.concatenate(
        [jnp.where(is_boundary, idx_arr, cap)[1:],
         jnp.full((1,), cap, jnp.int32)]
    )
    d = 1
    while d < cap:
        x = jnp.minimum(
            x, jnp.concatenate([x[d:], jnp.full((d,), cap, jnp.int32)])
        )
        d *= 2
    return jnp.where(is_start, x - idx_arr, 0).astype(jnp.uint32)


def _select_first_s(chi, clo, eligible, run_count, s: int):
    """First-s selection over SORTED candidate planes WITHOUT
    ``jnp.nonzero``: the non-eligible lanes are padded out and the planes
    re-sorted — the eligible candidates, already ascending, then form the
    prefix (pad-and-resort; ROADMAP D3 compares it with ``nonzero``).

    Returns ``(values u64[s], counts u32[s], n u32)`` with the usual
    U64MAX/0 padding; ``run_count=None`` 1-fills the counts.
    """
    U32MAX = jnp.uint32(0xFFFFFFFF)
    cap = chi.shape[0]
    sel_hi = jnp.where(eligible, chi, U32MAX)
    sel_lo = jnp.where(eligible, clo, U32MAX)
    sel_cnt = None
    if run_count is not None:
        sel_hi, sel_lo, sel_cnt = _sort_planes_flat(
            sel_hi, sel_lo, jnp.where(eligible, run_count, jnp.uint32(0))
        )
    else:
        sel_hi, sel_lo = _sort_planes_flat(sel_hi, sel_lo)
    if cap < s:
        pad_n = s - cap
        sel_hi = jnp.concatenate([sel_hi, jnp.full((pad_n,), U32MAX)])
        sel_lo = jnp.concatenate([sel_lo, jnp.full((pad_n,), U32MAX)])
        if sel_cnt is not None:
            sel_cnt = jnp.concatenate(
                [sel_cnt, jnp.zeros((pad_n,), jnp.uint32)]
            )
    shs, sls = sel_hi[:s], sel_lo[:s]
    opad = (shs == U32MAX) & (sls == U32MAX)
    vals64 = (shs.astype(jnp.uint64) << jnp.uint64(32)) | sls.astype(
        jnp.uint64
    )
    values = jnp.where(opad, _U64MAX, vals64)
    counts = jnp.where(
        opad,
        jnp.uint32(0),
        sel_cnt[:s] if sel_cnt is not None else jnp.uint32(1),
    )
    n = jnp.sum(~opad).astype(jnp.uint32)
    return values, counts, n


def _row_sort(yhi, ylo):
    """One-key ascending row sort (the candidate compaction)."""
    return jax.lax.sort((yhi, ylo), num_keys=1)


@partial(jax.jit, static_argnames=("s", "min_cov"))
def bottom_k_distinct(hashes: jax.Array, valid: jax.Array, *, s: int, min_cov: int = 1):
    """Bottom-s distinct hashes with counts from a flat pool.

    Args:
      hashes: u64[N] hash pool (any order).
      valid:  bool[N] mask of live entries.
      s: sketch size (minHashesPerWindow).
      min_cov: minimum multiplicity for admission (reads mode).

    Returns ``(values u64[s], counts u32[s], n u32)`` where only the first
    ``n`` slots are meaningful; unused slots hold U64MAX/0.
    """
    x = jnp.where(valid, hashes.astype(jnp.uint64), _U64MAX)
    # sort as two native u32 keys (hi, lo) — lexicographic == u64 order —
    # instead of an emulated-u64 comparator
    hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    x = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    N = x.shape[0]

    is_boundary = jnp.concatenate([jnp.array([True]), x[1:] != x[:-1]])
    is_start = is_boundary & (x != _U64MAX)

    # run length at each start, gather-free: next_boundary[i] = smallest
    # j > i that begins any run — including the padding run, so the last
    # real run is not overcounted (reverse cumulative min of masked idx)
    idx_arr = jnp.arange(N, dtype=jnp.int32)
    boundary_or_inf = jnp.where(is_boundary, idx_arr, N)
    nxt = jax.lax.cummin(boundary_or_inf[::-1])[::-1]
    nxt = jnp.concatenate([nxt[1:], jnp.array([N], jnp.int32)])
    run_count = jnp.where(is_start, nxt - idx_arr, 0).astype(jnp.uint32)

    eligible = is_start & (run_count >= min_cov)
    idx = jnp.nonzero(eligible, size=s, fill_value=N)[0]
    pad = idx >= N
    idx = jnp.minimum(idx, N - 1)
    values = jnp.where(pad, _U64MAX, x[idx])
    counts = jnp.where(pad, jnp.uint32(0), run_count[idx])
    n = jnp.sum(~pad).astype(jnp.uint32)
    return values, counts, n


@partial(
    jax.jit,
    static_argnames=("s", "min_cov", "boost", "need_counts", "compact"),
)
def bottom_k_threshold_planes(
    lo: jax.Array,  # u32[N] low hash words
    hi: jax.Array,  # u32[N] high hash words
    valid: jax.Array,  # bool[N]
    *,
    s: int,
    min_cov: int = 1,
    boost: int = 1,
    need_counts: bool = True,
    compact: bool | None = None,
):
    """Threshold-filtered bottom-s on (lo, hi) u32 PLANES.

    The whole kernel runs on (lo, hi) u32 planes; u64 is materialized
    only for the ``s`` output slots.

    Algorithm unchanged from the u64 formulation (see
    :func:`bottom_k_threshold`): threshold mask -> [C, cols] one-key row
    sort compaction with an exact displacement check -> two-key candidate
    sort -> run-length -> min_cov admission.
    """
    U32MAX = jnp.uint32(0xFFFFFFFF)
    N = lo.shape[0]
    # i64 counts (staged through i32 row partials — an int64-wide vector
    # pass is ~100x off HBM speed here): a pool with >= 2^31 valid
    # entries would silently wrap i32 counters and corrupt the threshold
    # fraction / all_taken / ok logic
    n_valid = _staged_sum_i64(valid)
    frac = jnp.minimum(
        (8.0 * s * boost) / jnp.maximum(n_valid.astype(jnp.float32), 1.0),
        1.0,
    )
    # threshold on the HI plane only: hi <= t_hi over-collects by at most
    # one hi-granule (~2^32 values), well inside the 8x headroom; every
    # copy of a kept value shares its hi, so counts stay exact
    sat = frac >= 1.0
    t_hi = jnp.where(
        sat, U32MAX, (frac * float(2**32)).astype(jnp.uint32)
    )
    pad = (lo == U32MAX) & (hi == U32MAX)
    mask = valid & (hi <= t_hi) & ~pad
    # not a default (see _compact_supported); explicit compact=True is
    # still validity-gated
    if bool(compact) and _compact_supported(N, s, boost, min_cov, need_counts):
        # counts-free path: group-extraction compaction instead of the
        # full-pool row sort
        all_taken = _staged_sum_i64(mask) >= n_valid
        mlo = jnp.where(mask, lo, U32MAX)
        mhi = jnp.where(mask, hi, U32MAX)
        return _bottom_k_compact_tail(mlo, mhi, all_taken, s=s, boost=boost)
    m = _staged_sum_i64(mask)

    # batched row sort over 4096-wide rows (the width is a tuning
    # constant; not yet re-chosen on the GPU)
    if N % 4096 == 0:
        cols = 4096
    elif N % 1024 == 0:
        cols = 1024
    else:
        cols = 1
    C = N // cols
    P = min(cols, max(16, -(-32 * s // max(C, 1))))
    ylo = jnp.where(mask, lo, U32MAX).reshape(C, cols)
    yhi = jnp.where(mask, hi, U32MAX).reshape(C, cols)
    yhi, ylo = _row_sort(yhi, ylo)
    row_counts = jnp.sum(mask.reshape(C, cols).astype(jnp.int32), axis=1)
    row_overflow = jnp.max(row_counts) > P
    chi = yhi[:, :P].reshape(C * P)
    clo = ylo[:, :P].reshape(C * P)
    cap = C * P
    cpad = (chi == U32MAX) & (clo == U32MAX)
    prefix_count = jnp.sum(((chi <= t_hi) & ~cpad).astype(jnp.int64))
    compaction_ok = ~row_overflow & (prefix_count == m)

    # run-length over the sorted candidates (planes throughout)
    chi, clo = _sort_planes_flat(chi, clo)
    neq = (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])
    is_boundary = jnp.concatenate([jnp.array([True]), neq])
    is_start = is_boundary & ~((chi == U32MAX) & (clo == U32MAX))
    if need_counts or min_cov > 1:
        run_count = _run_counts_sorted(is_boundary, is_start, cap)
        eligible = is_start & (run_count >= min_cov)
    else:
        # default sketching (min_cov=1, multiplicities unused): skip the
        # run-length machinery
        run_count = None
        eligible = is_start
    n_eligible = jnp.sum(eligible.astype(jnp.int32))

    values, counts, n = _select_first_s(chi, clo, eligible, run_count, s)

    all_taken = m >= n_valid  # threshold saturated: candidates = whole pool
    ok = compaction_ok & ((n_eligible >= s) | all_taken)
    return values, counts, n, ok


@partial(
    jax.jit,
    static_argnames=(
        "s", "min_cov", "need_counts", "boost", "compact", "collect_all",
        "expected_s",
    ),
)
def bottom_k_premasked_planes(
    lo: jax.Array,  # u32[N], U32MAX on BOTH planes marks a dropped lane
    hi: jax.Array,  # u32[N]
    all_taken: jax.Array,  # bool scalar: the threshold was saturated
    *,
    s: int,
    min_cov: int = 1,
    need_counts: bool = True,
    boost: int = 1,
    compact: bool | None = None,
    collect_all: bool = False,
    expected_s: int | None = None,
):
    """Threshold bottom-k over planes the producer already masked (the
    threshold-fused hash kernel writes U32MAX to every lane that is
    invalid, past the sequence end, or above t_hi) — starts directly at
    the candidate compaction, skipping the mask/where passes.

    Same returns and ``ok`` contract as
    :func:`bottom_k_threshold_planes`; the caller owns the threshold
    (and its ``boost`` retries — ``boost`` here only sizes the compact
    path's selection prefix and gates its overflow margins) and passes
    ``all_taken`` = saturation.

    ``collect_all=True`` flips the contract for the reads-mode chunk
    merge (Sketch.cpp:1299-1488 + MinHashHeap.cpp:78-95 semantics built
    distributively): return EVERY distinct sub-threshold survivor with
    its exact count — ``s`` is then the slot capacity, ``ok`` means "no
    survivor was truncated" (``n_eligible <= s``) rather than "collected
    at least s".  The caller sums counts across chunks, applies min_cov
    AFTER the merge, and checks global sufficiency itself.
    """
    U32MAX = jnp.uint32(0xFFFFFFFF)
    N = lo.shape[0]
    if (
        not collect_all
        and bool(compact)
        and _compact_supported(N, s, boost, min_cov, need_counts)
    ):
        return _bottom_k_compact_tail(lo, hi, all_taken, s=s, boost=boost)
    pad = (lo == U32MAX) & (hi == U32MAX)
    m = _staged_sum_i64(~pad)

    if N % 4096 == 0:
        cols = 4096
    elif N % 1024 == 0:
        cols = 1024
    else:
        cols = 1
    C = N // cols
    # per-row candidate capacity: sized from the THRESHOLD's expected
    # survivor count (expected_s, collect-all mode: the slot count s is
    # the capacity, not the density — sizing P from it would balloon the
    # candidate cap 16x)
    ps = expected_s if expected_s is not None else s
    P = min(cols, max(16, -(-32 * ps // max(C, 1))))
    ylo = lo.reshape(C, cols)
    yhi = hi.reshape(C, cols)
    yhi, ylo = _row_sort(yhi, ylo)
    row_counts = jnp.sum((~pad).reshape(C, cols).astype(jnp.int32), axis=1)
    row_overflow = jnp.max(row_counts) > P
    chi = yhi[:, :P].reshape(C * P)
    clo = ylo[:, :P].reshape(C * P)
    cap = C * P
    cpad = (chi == U32MAX) & (clo == U32MAX)
    prefix_count = jnp.sum((~cpad).astype(jnp.int64))
    compaction_ok = ~row_overflow & (prefix_count == m)

    chi, clo = _sort_planes_flat(chi, clo)
    neq = (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])
    is_boundary = jnp.concatenate([jnp.array([True]), neq])
    is_start = is_boundary & ~((chi == U32MAX) & (clo == U32MAX))
    if need_counts or min_cov > 1:
        run_count = _run_counts_sorted(is_boundary, is_start, cap)
        eligible = is_start & (run_count >= min_cov)
    else:
        run_count = None
        eligible = is_start
    n_eligible = jnp.sum(eligible.astype(jnp.int32))

    values, counts, n = _select_first_s(chi, clo, eligible, run_count, s)
    if collect_all:
        ok = compaction_ok & (n_eligible <= s)
    else:
        ok = compaction_ok & ((n_eligible >= s) | all_taken)
    return values, counts, n, ok


@jax.jit
def distinct_counts_planes(
    lo: jax.Array,  # u32[N] low hash words
    hi: jax.Array,  # u32[N] high hash words
    valid: jax.Array,  # bool[N]
):
    """ALL distinct hash values + multiplicities of a pool, on device.

    Backs `screen`'s query-side counting (CommandScreen.cpp:81-151): the
    reference hashes every query k-mer into a host hash table; here the
    pool is sorted as u32 planes (batched row sorts + bitonic merge),
    run-length encoded, duplicates padded out, and SORTED AGAIN with the
    counts as payload so the distinct values form an ascending prefix —
    only that prefix ever leaves the device.

    Returns ``(vlo u32[N], vhi u32[N], counts u32[N], n_distinct i64)``
    with values ascending in the first ``n_distinct`` slots; slots past
    it hold U32MAX/0.  The u64 recombine is left to the caller's host
    side.
    """
    U32MAX = jnp.uint32(0xFFFFFFFF)
    N = lo.shape[0]
    mlo = jnp.where(valid, lo, U32MAX)
    mhi = jnp.where(valid, hi, U32MAX)
    shi, slo = _sort_planes_flat(mhi, mlo)
    neq = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    is_boundary = jnp.concatenate([jnp.array([True]), neq])
    is_start = is_boundary & ~((shi == U32MAX) & (slo == U32MAX))
    n_distinct = _staged_sum_i64(is_start)
    n_valid = _staged_sum_i64(valid).astype(jnp.int32)

    # counts WITHOUT a full-pool run-length pass: carry each run-start's
    # POOL POSITION through the dedup sort; the
    # compacted prefix is position-ascending, so each count is just the
    # difference of consecutive start positions (the last run ends at
    # n_valid — every valid lane sorts before the first pad).
    idx_arr = jnp.arange(N, dtype=jnp.int32)
    vhi, vlo, pos = _sort_planes_flat(
        jnp.where(is_start, shi, U32MAX),
        jnp.where(is_start, slo, U32MAX),
        jnp.where(is_start, idx_arr, 0).astype(jnp.uint32),
    )
    pos = pos.astype(jnp.int32)
    nxt_pos = jnp.concatenate([pos[1:], jnp.zeros((1,), jnp.int32)])
    j = idx_arr  # output slot index
    last = j + 1 >= n_distinct
    counts = jnp.where(last, n_valid - pos, nxt_pos - pos)
    counts = jnp.where(j < n_distinct, counts, 0).astype(jnp.uint32)
    return vlo, vhi, counts, n_distinct


@partial(
    jax.jit,
    static_argnames=("s", "min_cov", "boost", "need_counts", "compact"),
)
def bottom_k_threshold(
    hashes: jax.Array,
    valid: jax.Array,
    *,
    s: int,
    min_cov: int = 1,
    boost: int = 1,
    need_counts: bool = True,
    compact: bool | None = None,
):
    """Threshold-filtered bottom-s: u64 entry point.

    Splits the pool into u32 planes ONCE (the only u64-wide traffic) and
    runs :func:`bottom_k_threshold_planes`.  Callers that already hold
    planes (the fused classic pipeline) skip the split entirely.

    Returns ``(values, counts, n, ok)``; ``ok=False`` means the filter
    under-collected (non-uniform pool, or ``min_cov`` admission much
    sparser than the value density) or overflowed the compaction cap —
    the caller retries with a larger ``boost`` (threshold multiplier) or
    falls back to :func:`bottom_k_distinct`.
    """
    x = jnp.where(valid, hashes.astype(jnp.uint64), _U64MAX)
    lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
    return bottom_k_threshold_planes(
        lo, hi, jnp.asarray(valid), s=s, min_cov=min_cov, boost=boost,
        need_counts=need_counts, compact=compact,
    )


def bottom_k_host(hashes, s: int, min_cov: int = 1):
    """NumPy fallback / parity model for :func:`bottom_k_distinct`."""
    values, counts = np.unique(np.asarray(hashes, dtype=np.uint64), return_counts=True)
    keep = counts >= min_cov
    values, counts = values[keep], counts[keep]
    return values[:s], counts[:s].astype(np.uint32)


def estimate_set_size(values: np.ndarray, s: int, bits: int = 64) -> float:
    """Cardinality estimate from the top (largest kept) hash
    (MinHashHeap.h:45): ``2^bits * k / topHash``."""
    if len(values) < s:
        return float(len(values))
    top = float(values[s - 1])
    if top == 0:
        return float(len(values))
    return (2.0**bits) * s / top


def estimate_multiplicity(counts: np.ndarray) -> float:
    """Mean multiplicity of kept hashes (MinHashHeap.h:44)."""
    if len(counts) == 0:
        return 0.0
    return float(np.sum(counts)) / len(counts)

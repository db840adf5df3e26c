"""Batched sketch-intersection kernels (the `dist` hot path).

The reference compares sketch pairs with a serial merge-join per pair on a
thread pool (CommandDistance.cpp:365-430, <=4096 pairs per task).  For
*sorted distinct* hash lists the walk has a closed-form batch equivalent:

With ``U`` the ascending distinct union of lists ``A`` and ``B`` and ``S``
the sketch-size cap, the walk counts

* ``common`` = number of shared values among the first ``min(|U|, S)``
  union elements, and
* ``denom`` = ``min(|U|, S)``.

A shared value ``x = A[i]`` has union rank ``i + rank_B(x) - c_before(x)``
(``c_before`` = shared values smaller than ``x``), so membership +
searchsorted + a cumulative sum reproduce the walk exactly — one
``O(S log S)`` vectorized pass per pair, batched over all pairs with
``vmap``.  Equivalence to the literal walk is asserted in tests.

This kernel requires sorted, internally-distinct lists (true for every
classic sketch; the unsorted fingerprint quirk path uses the host walk in
models.distance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # NumPy: no jnp work at import


@partial(jax.jit, static_argnames=("sketch_size",))
def pairwise_common_denom(
    ref: jax.Array,  # u64[R, S] padded with U64MAX
    ref_len: jax.Array,  # i32[R]
    qry: jax.Array,  # u64[Q, S]
    qry_len: jax.Array,  # i32[Q]
    *,
    sketch_size: int,
):
    """common/denom of the capped merge-join for every (ref, query) pair.

    Returns ``(common i32[R, Q], denom i32[R, Q])``.

    Gather-free formulation: each pair concatenates its two sorted lists
    and sorts the ``2S`` values (two native u32 keys); a shared value then
    appears as an adjacent equal pair (within-list distinctness guarantees
    the duplicate is cross-list), and the union rank of a value is the
    running count of run starts.  ``common`` counts duplicates whose value
    rank is below the cap; ``denom = min(|union|, S)``.  The earlier
    ``searchsorted``-based version had the same semantics (asserted
    against the literal walk in tests).
    """

    S = ref.shape[1]
    S2 = 1 << (S - 1).bit_length()  # pad each list to a power of two

    def one_pair(A, la, B, lb):
        # mask padding beyond the valid lengths to U64MAX
        idx = jnp.arange(S, dtype=jnp.int32)
        Am = jnp.where(idx < la, A, _U64MAX)
        Bm = jnp.where(idx < lb, B, _U64MAX)
        pad = S2 - S
        if pad:
            Am = jnp.concatenate([Am, jnp.full((pad,), _U64MAX)])
            Bm = jnp.concatenate([Bm, jnp.full((pad,), _U64MAX)])
        # ascending ++ descending is bitonic; a bitonic MERGE (log2(2*S2)
        # static-stride min/max stages) sorts it ~11x cheaper than a full
        # sort — the inputs are already sorted, only the interleave is new
        x = jnp.concatenate([Am, Bm[::-1]])
        n2 = 2 * S2
        d = S2
        while d >= 1:
            y = x.reshape(n2 // (2 * d), 2, d)
            lo_ = jnp.minimum(y[:, 0, :], y[:, 1, :])
            hi_ = jnp.maximum(y[:, 0, :], y[:, 1, :])
            x = jnp.stack([lo_, hi_], axis=1).reshape(n2)
            d //= 2
        eq_prev = jnp.concatenate([jnp.array([False]), x[1:] == x[:-1]])
        live = x != _U64MAX
        is_start = ~eq_prev & live
        # union rank of each element's value (0-based over distinct values)
        rank = jnp.cumsum(is_start.astype(jnp.int32)) - 1
        common = jnp.sum(
            (eq_prev & live & (rank < sketch_size)).astype(jnp.int32)
        )
        union = jnp.sum(is_start.astype(jnp.int32))
        denom = jnp.minimum(union, sketch_size)
        return common, denom

    f = jax.vmap(
        jax.vmap(one_pair, in_axes=(None, None, 0, 0)), in_axes=(0, 0, None, None)
    )
    return f(ref, ref_len, qry, qry_len)


from functools import lru_cache


@lru_cache(maxsize=None)
def _packed_tile_fn(sketch_size: int, pack: bool):
    """Module-level jitted tile (common/denom, optionally packed into one
    int32 as ``c << 16 | d``) — cached per (sketch_size, pack) so repeated
    ``all_pairs_common_denom`` calls reuse one executable instead of
    recompiling a fresh closure every invocation.  Packing is only enabled
    for ``sketch_size < 2**15`` so that ``c << 16`` cannot touch the int32
    sign bit (a common >= 32768 would unpack as a negative count)."""

    @jax.jit
    def f(r, rl, q, ql):
        c, d = pairwise_common_denom(r, rl, q, ql, sketch_size=sketch_size)
        return ((c << 16) | d) if pack else (c, d)

    return f


def _pad_batch(arrays, S=None):
    n = len(arrays)
    S = S or max((len(a) for a in arrays), default=1)
    out = np.full((n, max(S, 1)), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    lens = np.zeros((n,), np.int32)
    for i, a in enumerate(arrays):
        a = np.asarray(a, np.uint64)[:S]
        out[i, : len(a)] = a
        lens[i] = len(a)
    return out, lens


def all_pairs_common_denom(refs, qrys, sketch_size: int, tile: int | None = None):
    """Host wrapper: lists of sorted hash arrays -> (common, denom) [R, Q].

    Tiles the pair grid in ``tile x tile`` blocks so the vmapped kernel's
    per-pair intermediates stay bounded at large scale (the bitonic merge
    materializes ``[tile, tile, 2S]`` u64 stages; ``route.compare_tile``
    picks the tile per platform); every tile reuses one compiled shape.

    With multiple visible devices the query axis of each tile shards over a
    1-D ``dp`` mesh (tiles widen to ``D x tile`` queries, each device
    computing its own ``tile x tile`` block; ``parallel.sharded``), so
    `dist`/`triangle`/`screen` scale across chips with no CLI changes.
    Results are bitwise identical to the single-device run.
    """
    from fpmash_tpu.parallel.sharded import sharded_all_pairs, visible_device_count

    if tile is None:
        from fpmash_tpu import route

        tile = route.compare_tile()

    S = max(
        max((len(a) for a in refs), default=1),
        max((len(a) for a in qrys), default=1),
        1,
    )
    R, Q = len(refs), len(qrys)
    ref, ref_len = _pad_batch(refs, S)
    qry, qry_len = _pad_batch(qrys, S)
    D = visible_device_count()
    if D <= 1 and R * Q <= tile * tile:
        common, denom = pairwise_common_denom(
            jnp.asarray(ref),
            jnp.asarray(ref_len),
            jnp.asarray(qry),
            jnp.asarray(qry_len),
            sketch_size=sketch_size,
        )
        return np.asarray(common), np.asarray(denom)

    # fixed-shape tiles (padded) so every tile hits the same executable;
    # per-device query-tile width qd keeps small grids from inflating to
    # D full tiles of padding
    rtile = min(tile, -(-R // 8) * 8)  # multiples of 8
    qd = min(tile, -(-(-(-Q // D)) // 8) * 8)
    qtile = qd * D
    Rp = ((R + rtile - 1) // rtile) * rtile
    Qp = ((Q + qtile - 1) // qtile) * qtile
    refp = np.full((Rp, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    refp[:R] = ref
    reflp = np.zeros(Rp, np.int32)
    reflp[:R] = ref_len
    qryp = np.full((Qp, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    qryp[:Q] = qry
    qrylp = np.zeros(Qp, np.int32)
    qrylp[:Q] = qry_len

    mesh = None
    if D > 1:
        from fpmash_tpu.parallel.mesh import default_mesh

        mesh = default_mesh(D)

    common = np.zeros((R, Q), np.int32)
    denom = np.zeros((R, Q), np.int32)
    # upload the padded sketch sets ONCE and slice tiles ON DEVICE (a
    # per-tile upload re-sends ~8 MB per tile).  Results come back packed
    # (common << 16 | denom, both <= sketch_size < 2^15) to halve the
    # down-transfer.
    refd = jnp.asarray(refp)
    refld = jnp.asarray(reflp)
    qryd = jnp.asarray(qryp)
    qryld = jnp.asarray(qrylp)

    # < 2**15, not 2**16: the tile returns int32, and c << 16 with
    # common >= 32768 would wrap the sign bit (unpacking as negative)
    pack = sketch_size < (1 << 15)
    _packed_tile = _packed_tile_fn(sketch_size, pack)

    # keep a small window of in-flight tiles: tiles are data-independent,
    # so the device overlaps transfers with compute instead of paying a
    # host round-trip per tile, while the window bounds on-device result
    # buffering at large R*Q
    pending = []

    def _drain(keep: int):
        while len(pending) > keep:
            r0, q0, c, d = pending.pop(0)
            rhi, qhi = min(r0 + rtile, R), min(q0 + qtile, Q)
            if d is None:
                packed = np.asarray(c)[: rhi - r0, : qhi - q0]
                common[r0:rhi, q0:qhi] = packed >> 16
                denom[r0:rhi, q0:qhi] = packed & 0xFFFF
            else:
                common[r0:rhi, q0:qhi] = np.asarray(c)[: rhi - r0, : qhi - q0]
                denom[r0:rhi, q0:qhi] = np.asarray(d)[: rhi - r0, : qhi - q0]

    for r0 in range(0, Rp, rtile):
        for q0 in range(0, Qp, qtile):
            tiles = (
                refd[r0 : r0 + rtile],
                refld[r0 : r0 + rtile],
                qryd[q0 : q0 + qtile],
                qryld[q0 : q0 + qtile],
            )
            if mesh is not None:
                c, d = sharded_all_pairs(mesh, *tiles, sketch_size)
                pending.append((r0, q0, c, d))
            elif pack:
                pending.append((r0, q0, _packed_tile(*tiles), None))
            else:
                c, d = _packed_tile(*tiles)
                pending.append((r0, q0, c, d))
            _drain(8)
    _drain(0)
    return common, denom


@partial(jax.jit, static_argnames=())
def positional_matches(h1: jax.Array, l1: jax.Array, h2: jax.Array, l2: jax.Array):
    """Batched positional fingerprint comparison (CommandTriangle.cpp:265):
    per pair, matches = sum(h1[i] == h2[i], i < min(l1, l2))."""
    n = jnp.minimum(l1, l2)
    idx = jnp.arange(h1.shape[-1], dtype=jnp.int32)
    eq = (h1 == h2) & (idx[None, :] < n[:, None])
    return jnp.sum(eq.astype(jnp.int32), axis=-1), n


@partial(jax.jit, static_argnames=())
def pairwise_positional(hashes: jax.Array, lens: jax.Array):
    """All-pairs positional matches for one sketch set [N, S]:
    ``matches[a, b] = sum(h[a, i] == h[b, i], i < min(len_a, len_b))``.

    The padded tail is U64MAX on both sides, which would self-match, so
    equality is masked by the min-length bound per pair.
    """

    def one(a, la):
        n = jnp.minimum(la, lens)  # [N]
        idx = jnp.arange(hashes.shape[-1], dtype=jnp.int32)
        eq = (a[None, :] == hashes) & (idx[None, :] < n[:, None])
        return jnp.sum(eq.astype(jnp.int32), axis=-1), n

    return jax.vmap(one)(hashes, lens)


def all_pairs_positional(fingerprint_hashes):
    """Host wrapper: list of (unsorted) hash arrays -> (matches, minlen)
    [N, N] for the fingerprint triangle.  With multiple visible devices the
    row axis shards over the dp mesh (bitwise-identical results)."""
    from fpmash_tpu.parallel.sharded import (
        sharded_all_pairs_positional,
        visible_device_count,
    )

    h, lens = _pad_batch(fingerprint_hashes)
    D = visible_device_count()
    if D > 1 and len(fingerprint_hashes) >= D:
        from fpmash_tpu.parallel.mesh import default_mesh

        m, n = sharded_all_pairs_positional(default_mesh(D), h, lens)
        return np.asarray(m), np.asarray(n)
    m, n = pairwise_positional(jnp.asarray(h), jnp.asarray(lens))
    return np.asarray(m), np.asarray(n)

"""Batched device kernel for the ORDER-DEPENDENT sketch merge-join walk.

The reference runs its capped merge-join (CommandDistance.cpp:376-400)
over whatever order the hash lists are in.  For classic sketches the
lists are sorted and the closed-form batch kernel in ``ops/compare.py``
applies; for fingerprint sketches built from raw ``.txt`` hash lists
(initFromFingerprints, Sketch.cpp:56-151) the lists are in *file order*
and the walk's result is order-dependent — there is no closed form, the
automaton must actually be stepped.

This kernel steps ALL pairs of a tile in lockstep: the per-pair state
``(i, j, common, denom)`` lives in ``[P]`` vectors and each iteration
performs two flat gathers (``A[r, i]``, ``B[q, j]``) plus a handful of
elementwise ops, inside one ``lax.scan`` whose trip count is the walk's
worst case ``min(sketch_size, S_ref + S_qry)`` — short fingerprint lists
(the common case) cost proportionally few steps.  Equivalence with the
literal Python walk (models/distance.py:51, itself mirroring
CommandDistance.cpp:365-430) is asserted in tests on random unsorted
lists, including the post-loop denom fixup and cap.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("sketch_size",))
def pairwise_walk_common_denom(
    ref: jax.Array,  # u64[R, S1] hash lists in FILE order, padded arbitrarily
    ref_len: jax.Array,  # i32[R]
    qry: jax.Array,  # u64[Q, S2]
    qry_len: jax.Array,  # i32[Q]
    *,
    sketch_size: int,
):
    """(common i32[R, Q], denom i32[R, Q]) of the literal capped walk."""
    R, S1 = ref.shape
    Q, S2 = qry.shape
    refF = ref.reshape(-1)
    qryF = qry.reshape(-1)

    r_idx = jnp.repeat(jnp.arange(R, dtype=jnp.int32), Q)  # [P]
    q_idx = jnp.tile(jnp.arange(Q, dtype=jnp.int32), R)
    la = ref_len.astype(jnp.int32)[r_idx]
    lb = qry_len.astype(jnp.int32)[q_idx]
    P = R * Q

    # each loop iteration increments denom exactly once and consumes at
    # least one element, so the loop runs at most min(S, la+lb) times
    steps = int(min(sketch_size, S1 + S2))

    zeros = jnp.zeros((P,), jnp.int32)
    rbase = r_idx * S1
    qbase = q_idx * S2

    def body(state, _):
        i, j, common, denom = state
        live = (denom < sketch_size) & (i < la) & (j < lb)
        a = refF[jnp.minimum(rbase + i, R * S1 - 1)]
        b = qryF[jnp.minimum(qbase + j, Q * S2 - 1)]
        lt = a < b
        gt = b < a
        adv_i = live & ~gt  # a <= b
        adv_j = live & ~lt  # b <= a
        i = i + adv_i.astype(jnp.int32)
        j = j + adv_j.astype(jnp.int32)
        common = common + (live & ~lt & ~gt).astype(jnp.int32)
        denom = denom + live.astype(jnp.int32)
        return (i, j, common, denom), None

    (i, j, common, denom), _ = jax.lax.scan(
        body, (zeros, zeros, zeros, zeros), None, length=steps
    )

    # post-loop fixup (CommandDistance.cpp:392-400): leftover elements of
    # either list pad denom up to the cap
    short = denom < sketch_size
    denom = jnp.where(short, denom + jnp.maximum(la - i, 0) + jnp.maximum(lb - j, 0), denom)
    denom = jnp.minimum(denom, sketch_size)
    return common.reshape(R, Q), denom.reshape(R, Q)


def _pad_batch(arrays, S=None):
    n = len(arrays)
    S = S or max((len(a) for a in arrays), default=1)
    out = np.zeros((n, max(S, 1)), np.uint64)
    lens = np.zeros((n,), np.int32)
    for i, a in enumerate(arrays):
        a = np.asarray(a, np.uint64)[:S]
        out[i, : len(a)] = a
        lens[i] = len(a)
    return out, lens


def all_pairs_walk(refs, qrys, sketch_size: int, tile: int = 256):
    """Host wrapper: lists of (unsorted) hash arrays -> (common, denom).

    Tiles the pair grid so the ``[tile*tile]`` state vectors and the
    flat-gather working set stay bounded; every tile reuses one compiled
    shape.  With multiple visible devices the query tiles shard over the
    dp mesh (parallel/sharded.py), bitwise identical to one device.
    """
    from fpmash_tpu.parallel.sharded import sharded_all_pairs_walk, visible_device_count

    S1 = max((len(a) for a in refs), default=1)
    S2 = max((len(a) for a in qrys), default=1)
    R, Q = len(refs), len(qrys)
    ref, ref_len = _pad_batch(refs, max(S1, 1))
    qry, qry_len = _pad_batch(qrys, max(S2, 1))

    D = visible_device_count()
    if D <= 1 and R <= tile and Q <= tile:
        c, d = pairwise_walk_common_denom(
            jnp.asarray(ref), jnp.asarray(ref_len), jnp.asarray(qry),
            jnp.asarray(qry_len), sketch_size=sketch_size,
        )
        return np.asarray(c), np.asarray(d)

    rtile = min(tile, -(-R // 8) * 8)
    qd = min(tile, -(-(-(-Q // D)) // 8) * 8) if D > 1 else min(tile, -(-Q // 8) * 8)
    qtile = qd * D if D > 1 else qd
    Rp = -(-R // rtile) * rtile
    Qp = -(-Q // qtile) * qtile
    refp = np.zeros((Rp, ref.shape[1]), np.uint64)
    refp[:R] = ref
    reflp = np.zeros(Rp, np.int32)
    reflp[:R] = ref_len
    qryp = np.zeros((Qp, qry.shape[1]), np.uint64)
    qryp[:Q] = qry
    qrylp = np.zeros(Qp, np.int32)
    qrylp[:Q] = qry_len

    mesh = None
    if D > 1:
        from fpmash_tpu.parallel.mesh import default_mesh

        mesh = default_mesh(D)

    common = np.zeros((R, Q), np.int32)
    denom = np.zeros((R, Q), np.int32)
    # upload once, slice tiles on device (see ops/compare.py)
    refd, refld = jnp.asarray(refp), jnp.asarray(reflp)
    qryd, qryld = jnp.asarray(qryp), jnp.asarray(qrylp)
    pending = []

    def _drain(keep: int):
        while len(pending) > keep:
            r0, q0, c, d = pending.pop(0)
            rhi, qhi = min(r0 + rtile, R), min(q0 + qtile, Q)
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
                c, d = sharded_all_pairs_walk(mesh, *tiles, sketch_size)
            else:
                c, d = pairwise_walk_common_denom(*tiles, sketch_size=sketch_size)
            pending.append((r0, q0, c, d))
            _drain(8)
    _drain(0)
    return common, denom

"""Device dispatch for all 10 lyn2vec factorization families.

Every family the reference CLI offers (lyn2vec.py:47-72) reduces to a
factor-start *boundary mask* over the padded ``[B, L]`` byte batch, built
from two automaton kernels plus mask algebra:

========================  ====================================================
CFL                       Duval mask (:func:`fpmash_tpu.ops.lyndon.cfl_boundary_mask`)
ICFL                      inverse-Lyndon mask (:mod:`fpmash_tpu.ops.icfl`)
CFL_ICFL-T                CFL mask | ICFL inside each CFL factor > T
CFL_COMB                  CFL(seq) | flip(CFL(revcomp(seq)))
ICFL_COMB                 ICFL(seq) | flip(ICFL(revcomp(seq)))
CFL_ICFL_COMB-T           CFL_ICFL-T(seq) | flip(CFL_ICFL-30(revcomp(seq)))
========================  ====================================================

The COMB ("double") rule works because the reference's two-pointer length
merge (factorizations_comb.py:213-246) is exactly the common refinement of
the two factorizations' cut positions, and the reversed factorization of
the reverse complement cuts ``seq`` at position ``n - c`` wherever the rc
factorization cuts at ``c``.  The rc side intentionally drops the
threshold argument — ``d_cfl_icfl(seq, T)`` uses the default C=30 on the
reverse complement (reference quirk, factorizations_comb.py:213-221) —
and ``<<``/``>>`` markers never materialize because fingerprints strip
them before emitting lengths (fingerprint_utils.py:461-465).

All of this is verified against the pure-Python scalar models
(fpmash_tpu.scalar.lyndon) and the vendored reference goldens in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fpmash_tpu.ops.icfl import cfl_icfl_boundary_mask, icfl_boundary_mask
from fpmash_tpu.ops.lyndon import cfl_boundary_mask, lengths_from_boundary

#: Family name -> (base family, threshold, comb) — thresholds match the
#: reference dispatch table name-for-name.
FAMILY_PLANS = {
    "CFL": ("cfl", None, False),
    "ICFL": ("icfl", None, False),
    "CFL_ICFL-10": ("cfl_icfl", 10, False),
    "CFL_ICFL-20": ("cfl_icfl", 20, False),
    "CFL_ICFL-30": ("cfl_icfl", 30, False),
    "CFL_COMB": ("cfl", None, True),
    "ICFL_COMB": ("icfl", None, True),
    "CFL_ICFL_COMB-10": ("cfl_icfl", 10, True),
    "CFL_ICFL_COMB-20": ("cfl_icfl", 20, True),
    "CFL_ICFL_COMB-30": ("cfl_icfl", 30, True),
}

# reverse-complement byte table: A<->T, C<->G, everything else 'N'
# (scalar model semantics); padding byte 0 stays 0.
_RC_LUT = np.full(256, ord("N"), np.uint8)
for _a, _b in ((b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A")):
    _RC_LUT[_a[0]] = _b[0]
_RC_LUT[0] = 0


def _base_mask(batch, n, base: str, threshold):
    if base == "cfl":
        return cfl_boundary_mask(batch, n), jnp.ones(batch.shape[0], bool)
    if base == "icfl":
        return icfl_boundary_mask(batch, n)
    return cfl_icfl_boundary_mask(batch, n, threshold)


def _complement(b):
    """Byte complement as a 5-way select chain (the 256-entry table
    applied with compares instead of a gather)."""
    A, C, G, T = (jnp.uint8(ord(x)) for x in "ACGT")
    N = jnp.uint8(ord("N"))
    z = jnp.uint8(0)
    return jnp.where(
        b == A, T,
        jnp.where(b == T, A,
                  jnp.where(b == C, G,
                            jnp.where(b == G, C, jnp.where(b == z, z, N)))),
    )


def _revcomp_batch(batch, n, uniform: bool = False):
    """Per-row reverse complement of the valid prefix, re-packed left.

    ``uniform=True`` (static) asserts every row has ``n == L`` — the
    production shift-window case — and lowers to a static reverse with no
    gather; the general case pays one ``take_along_axis``.
    """
    B, L = batch.shape
    if uniform:
        return _complement(batch[:, ::-1])
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    idx = jnp.clip(n[:, None] - 1 - iota, 0, L - 1)
    rev = jnp.take_along_axis(batch, idx, axis=1)
    rc = _complement(rev)
    return jnp.where(iota < n[:, None], rc, 0).astype(jnp.uint8)


def _flip_mask(mask, n, uniform: bool = False):
    """Map rc-coordinate factor starts to forward cut positions ``n - c``.

    Interior rc cuts (positions >= 1) flip to forward interior cuts; the
    rc start bit 0 flips to position n (not a boundary).  Bit 0 of the
    result is owned by the caller's forward mask.  ``uniform=True``
    (static, all rows full-width) uses a static reverse+shift, no gather.
    """
    B, L = mask.shape
    if uniform:
        # flipped[q] = mask[L - q] for q in [1, L-1] == reverse(mask)[q-1]
        shifted = jnp.concatenate(
            [jnp.zeros((B, 1), bool), mask[:, ::-1][:, : L - 1]], axis=1
        )
        return shifted
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    src = n[:, None] - iota
    valid = (iota >= 1) & (src >= 1)  # q in [1, n-1] <=> src in [1, n-1]
    flipped = jnp.take_along_axis(mask, jnp.clip(src, 0, L - 1), axis=1)
    return flipped & valid


@partial(jax.jit, static_argnames=("family", "uniform"))
def factor_boundary_mask(
    batch: jax.Array, lengths: jax.Array, family: str, uniform: bool = False
):
    """Factor-start mask for any of the 10 families.

    Returns ``(mask bool[B, L], ok bool[B])``; rows with ``ok=False``
    (ICFL level-capacity overflow — unobserved on DNA) must be recomputed
    by the caller with the scalar model.  ``uniform=True`` (static) asserts
    every row is full-width (``n == L``) or empty (``n == 0``) — the
    shift-window production shape — enabling gather-free COMB flips.
    """
    base, threshold, comb = FAMILY_PLANS[family]
    n = lengths.astype(jnp.int32)
    mask, ok = _base_mask(batch, n, base, threshold)
    if comb:
        rc = _revcomp_batch(batch, n, uniform)
        # reference quirk: the rc side always uses the default threshold
        rc_thr = 30 if base == "cfl_icfl" else threshold
        rc_mask, rc_ok = _base_mask(rc, n, base, rc_thr)
        mask = mask | _flip_mask(rc_mask, n, uniform)
        ok = ok & rc_ok
    return mask, ok


@partial(jax.jit, static_argnames=("family", "uniform"))
def factor_lengths_device(
    batch: jax.Array, lengths: jax.Array, family: str, uniform: bool = False
):
    """Factor lengths for any family: ``(fac_len[B, L], fac_count[B], ok[B])``."""
    n = lengths.astype(jnp.int32)
    mask, ok = factor_boundary_mask(batch, n, family, uniform)
    fac_len, fac_count = lengths_from_boundary(mask, n)
    return fac_len, fac_count, ok


def factorize_windows_device(windows, family: str):
    """Host convenience: strings -> per-window factor-length lists.

    Device kernel for every row, scalar model for the (essentially
    unreachable) overflow rows.
    """
    from fpmash_tpu.ops.lyndon import encode_batch
    from fpmash_tpu.scalar.lyndon import FACTORIZATIONS

    arr, lens = encode_batch(windows)
    uniform = bool(((lens == arr.shape[1]) | (lens == 0)).all())
    fac_len, fac_count, ok = jax.device_get(
        factor_lengths_device(jnp.asarray(arr), jnp.asarray(lens), family, uniform)
    )
    out = []
    fn = FACTORIZATIONS[family]
    for b, w in enumerate(windows):
        if ok[b]:
            out.append([int(x) for x in fac_len[b, : fac_count[b]]])
        else:  # pragma: no cover - requires >64 ICFL levels in one window
            out.append([len(f) for f in fn(w) if f not in ("<<", ">>")])
    return out

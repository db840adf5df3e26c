"""K-mer extraction, canonicalization and hashing — the classic sketch path.

Replaces the reference's per-k-mer inner loop ``addMinHashes``
(mash/src/mash/Sketch.cpp:664-735): case folding, alphabet validity
filtering, canonical strand selection (lexicographic min of forward vs
reverse complement, Sketch.cpp:721-723) and MurmurHash3 — all as batched
array ops under one ``jit``.

The window extraction builds a ``[n_kmers, k]`` view by gathering ``k``
shifted copies of the sequence; canonical selection compares the packed
big-endian representation of forward vs reverse-complement windows
(equivalent to ``memcmp``); hashing reuses
:func:`fpmash_tpu.ops.murmur3.murmur3_bytes_batch`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fpmash_tpu.ops.murmur3 import murmur3_bytes_batch

# IUPAC complement for A-Z, identity elsewhere (Sketch.cpp:1223-1258).
_IUPAC = {
    "A": "T", "B": "V", "C": "G", "D": "H", "G": "C", "H": "D", "K": "M",
    "M": "K", "N": "N", "R": "Y", "S": "S", "T": "A", "U": "A", "V": "B",
    "W": "W", "Y": "R",
}


def complement_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint8)
    for a, b in _IUPAC.items():
        table[ord(a)] = ord(b)
        table[ord(a.lower())] = ord(b.lower())
    return table


def alphabet_mask(alphabet: str) -> np.ndarray:
    mask = np.zeros(256, dtype=bool)
    for c in alphabet:
        mask[ord(c)] = True
    return mask


@partial(
    jax.jit,
    static_argnames=("k", "noncanonical", "preserve_case", "seed"),
)
def _kmer_hashes_acgt(
    seq: jax.Array,
    length: jax.Array,
    *,
    k: int,
    noncanonical: bool,
    preserve_case: bool,
    seed: int,
):
    """Lane-parallel DNA k-mer hashing (k <= 32): the whole window is kept
    as one 2-bit-packed u64 per position, so canonical selection is a
    single 64-bit min and no ``[N, k]`` byte matrix is ever materialized
    (the gather formulation costs k bytes of memory per position).

    Steps, all elementwise over ``[N]`` vectors (XLA fuses into one pass):

    1. 2-bit order-preserving codes A<C<G<T (code order == ASCII order, so
       integer comparison == memcmp, Sketch.cpp:721-723).
    2. ``F`` = big-endian packed window via k static shifted ORs;
       ``R`` = packed reverse complement (complement = code ^ 3, reversal
       by symmetric shift placement).
    3. canonical packed value = min(F, R)  (64-bit compare).
    4. ASCII byte reconstruction (3 selects per byte) into the
       little-endian u64 words MurmurHash3_x64_128 consumes.
    5. statically unrolled murmur blocks + tail (k is static).
    """
    from fpmash_tpu.ops.murmur3 import (
        _block_update,
        _finalize,
        _mix_k1,
        _mix_k2,
    )

    N = seq.shape[0]
    seq = seq.astype(jnp.uint8)
    length = length.astype(jnp.int32)
    if not preserve_case:
        lower = (seq > 96) & (seq < 123)
        seq = jnp.where(lower, seq - 32, seq)

    code = jnp.full(seq.shape, 4, jnp.uint32)
    for v, ch in enumerate(b"ACGT"):
        code = jnp.where(seq == jnp.uint8(ch), jnp.uint32(v), code)

    valid_char = code < 4
    c64 = jnp.minimum(code, 3).astype(jnp.uint64)

    # doubling ladder: F_m[p] = big-endian packed codes of window [p, p+m),
    # G_m[p] = little-endian packed complements of the same window, V_m[p]
    # = all chars valid.  F_2m = (F_m << 2m) | F_m[p+m]; O(log k) shifted
    # ORs instead of k.
    ladder = []  # (m, F_m, G_m, V_m)
    Fm, Gm, Vm = c64, c64 ^ jnp.uint64(3), valid_char
    m = 1
    while True:
        ladder.append((m, Fm, Gm, Vm))
        if m * 2 > k:
            break
        Fm = (Fm << jnp.uint64(2 * m)) | jnp.roll(Fm, -m)
        Gm = Gm | (jnp.roll(Gm, -m) << jnp.uint64(2 * m))
        Vm = Vm & jnp.roll(Vm, -m)
        m *= 2

    # greedy binary decomposition of k over the ladder
    F = jnp.zeros((N,), jnp.uint64)
    G = jnp.zeros((N,), jnp.uint64)
    valid = jnp.ones((N,), bool)
    built = 0
    for m, Fm, Gm, Vm in reversed(ladder):
        if built + m <= k:
            Fp = jnp.roll(Fm, -built) if built else Fm
            Gp = jnp.roll(Gm, -built) if built else Gm
            Vp = jnp.roll(Vm, -built) if built else Vm
            F = (F << jnp.uint64(2 * m)) | Fp
            G = G | (Gp << jnp.uint64(2 * built))
            valid = valid & Vp
            built += m
    assert built == k
    R = G
    pos = jnp.arange(N, dtype=jnp.int32)
    valid = valid & (pos <= length - k)

    P = F if noncanonical else jnp.minimum(F, R)

    # canonical packed codes -> ASCII bytes -> little-endian u64 words
    nwords = (k + 7) // 8
    if nwords % 2:
        nwords += 1  # murmur reads word pairs; extra word is zero
    words = []
    for w in range(nwords):
        acc = jnp.zeros((N,), jnp.uint64)
        for m in range(8):
            j = w * 8 + m
            if j >= k:
                break
            d = (P >> jnp.uint64(2 * (k - 1 - j))) & jnp.uint64(3)
            b = jnp.where(
                d == 0,
                jnp.uint64(ord("A")),
                jnp.where(
                    d == 1,
                    jnp.uint64(ord("C")),
                    jnp.where(d == 2, jnp.uint64(ord("G")), jnp.uint64(ord("T"))),
                ),
            )
            acc = acc | (b << jnp.uint64(8 * m))
        words.append(acc)

    seed64 = jnp.uint64(seed)
    h1 = jnp.full((N,), seed64)
    h2 = jnp.full((N,), seed64)
    nblocks = k // 16
    tail = k % 16
    for blk in range(nblocks):
        h1, h2 = _block_update(h1, h2, words[2 * blk], words[2 * blk + 1])
    if tail > 8:
        h2 = h2 ^ _mix_k2(words[2 * nblocks + 1])
    if tail > 0:
        h1 = h1 ^ _mix_k1(words[2 * nblocks])
    h1, _ = _finalize(h1, h2, jnp.uint64(k))
    return h1, valid


def kmer_hashes(
    seq: jax.Array,
    length: jax.Array,
    *,
    alphabet: str = "ACGT",
    k: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
    use64: bool = True,
):
    """Hash every valid k-mer of ``seq`` (u8[N], valid prefix ``length``).

    Returns ``(hashes u64[N], valid bool[N])`` — entry ``i`` covers the
    window starting at position ``i``; windows containing any character
    outside the alphabet, or extending past ``length``, are invalid
    (Sketch.cpp:696-713).  ``use64`` only controls the truncation done by
    the caller; the full 64-bit h1 is always returned.

    The default DNA alphabet takes the packed lane-parallel fast path
    (:func:`_kmer_hashes_acgt`); other alphabets (protein, custom ``-z``)
    use the generic gather formulation.
    """
    if set(alphabet) == set("ACGT") and k <= 32:
        return _kmer_hashes_acgt(
            seq, length, k=k, noncanonical=noncanonical,
            preserve_case=preserve_case, seed=seed,
        )
    return _kmer_hashes_generic(
        seq,
        length,
        alphabet=alphabet,
        k=k,
        noncanonical=noncanonical,
        preserve_case=preserve_case,
        seed=seed,
        use64=use64,
    )


@partial(
    jax.jit,
    static_argnames=("alphabet", "k", "noncanonical", "preserve_case", "seed", "use64"),
)
def _kmer_hashes_generic(
    seq: jax.Array,
    length: jax.Array,
    *,
    alphabet: str = "ACGT",
    k: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
    use64: bool = True,
):
    """Generic-alphabet gather formulation (see :func:`kmer_hashes`)."""
    N = seq.shape[0]
    seq = seq.astype(jnp.uint8)

    if not preserve_case:
        # lowercase a-z -> uppercase (Sketch.cpp:676-682)
        lower = (seq > 96) & (seq < 123)
        seq = jnp.where(lower, seq - 32, seq)

    # the 256-entry alphabet/complement tables are applied as short select
    # chains over the (few) characters they actually affect
    valid_char = jnp.zeros(seq.shape, bool)
    for ch in sorted(set(alphabet)):
        valid_char = valid_char | (seq == jnp.uint8(ord(ch)))

    # windows[i, j] = seq[i + j]
    windows = jnp.stack([jnp.roll(seq, -j) for j in range(k)], axis=1)
    valid_win = jnp.stack([jnp.roll(valid_char, -j) for j in range(k)], axis=1)
    pos = jnp.arange(N, dtype=jnp.int32)
    in_range = pos <= length - k
    valid = jnp.all(valid_win, axis=1) & in_range

    if not noncanonical:
        # reverse complement of each window, then memcmp-min selection.
        # Only alphabet characters need mapping: windows containing any
        # other character are invalid and never emitted.
        ctab_np = complement_table()
        rc = windows
        for ch in sorted(set(alphabet)):
            c = ord(ch)
            if ctab_np[c] != c:
                rc = jnp.where(windows == jnp.uint8(c), jnp.uint8(ctab_np[c]), rc)
        rc = rc[:, ::-1]
        # big-endian pack for lexicographic comparison, 8 bytes at a time
        def pack_be(w):
            pad = (-k) % 8
            if pad:
                w = jnp.pad(w, ((0, 0), (0, pad)))
            grp = w.reshape(N, -1, 8).astype(jnp.uint64)
            shifts = (jnp.uint64(56) - jnp.arange(8, dtype=jnp.uint64) * jnp.uint64(8))[None, None, :]
            return jnp.sum(grp << shifts, axis=-1, dtype=jnp.uint64)

        fwd_key = pack_be(windows)
        rc_key = pack_be(rc)
        # lexicographic tuple comparison fwd <= rc
        le = jnp.ones((N,), bool)
        decided = jnp.zeros((N,), bool)
        for w in range(fwd_key.shape[1]):
            f, r = fwd_key[:, w], rc_key[:, w]
            le = jnp.where(~decided & (f < r), True, le)
            le = jnp.where(~decided & (f > r), False, le)
            decided = decided | (f != r)
        windows = jnp.where(le[:, None], windows, rc)

    lengths = jnp.full((N,), k, jnp.int32)
    h1, _ = murmur3_bytes_batch(windows, lengths, seed=seed)
    return h1, valid


def encode_seq(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8).copy()


@partial(
    jax.jit,
    static_argnames=(
        "k", "s", "noncanonical", "preserve_case", "seed", "min_cov", "boost",
        "need_counts", "out_slots",
    ),
)
def classic_sketch_device(
    seq: jax.Array,  # u8[N]
    length: jax.Array,  # i32 scalar
    *,
    k: int,
    s: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
    min_cov: int = 1,
    boost: int = 1,
    need_counts: bool | None = None,
    out_slots: int | None = None,
):
    """Fused classic sketch: sequence bytes -> bottom-s MinHash, one jit.

    The full addMinHashes + MinHashHeap pipeline (Sketch.cpp:664-735,
    MinHashHeap.cpp) for DNA with 16 < k <= 32: the packed k-mer hash
    (:func:`_kmer_hashes_acgt`), a threshold on the hash's high 32 bits,
    then the planes bottom-k
    (:func:`fpmash_tpu.ops.bottomk.bottom_k_premasked_planes`) — only
    ``s``-sized results leave the device.

    The threshold fraction is computed against the STATIC padded N, not
    the valid length: it collects ``8*s*boost*(valid/N)`` candidates in
    expectation, so callers retry with a higher ``boost`` when
    valid << N (the ``ok`` flag reports under-collection;
    ``models.sketch._classic_sketch_direct`` gates inputs at N/8 and
    ladders boost 1 -> 2).

    Returns ``(values u64[s], counts u32[s], n u32, ok bool)`` with
    :func:`fpmash_tpu.ops.bottomk.bottom_k_threshold` semantics.  With
    ``out_slots`` (reads mode) the collect-all contract applies instead:
    every sub-threshold value comes back with its exact count in
    ``out_slots`` slots, and ``min_cov`` is left to the caller's
    cross-chunk merge.
    """
    from fpmash_tpu.ops.bottomk import bottom_k_premasked_planes

    if not 16 < k <= 32:
        raise ValueError(f"classic_sketch_device needs 16 < k <= 32, got {k}")
    if need_counts is None:
        # default CLI sketching consumes no multiplicities; reads mode
        # (min_cov/-M/-c) asks for them explicitly
        need_counts = min_cov > 1
    N = seq.shape[0]
    h1, valid = _kmer_hashes_acgt(
        seq, length, k=k, noncanonical=noncanonical,
        preserve_case=preserve_case, seed=seed,
    )
    frac_f = min(1.0, (8.0 * s * boost) / max(N - (k - 1), 1))
    sat = frac_f >= 1.0
    t_hi = 0xFFFFFFFF if sat else min(0xFFFFFFFF, int(frac_f * float(2**32)))
    lo = (h1 & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (h1 >> jnp.uint64(32)).astype(jnp.uint32)
    # dropped lanes (invalid, past the end, above the threshold) hold
    # U32MAX on both planes
    keep = valid & (hi <= jnp.uint32(t_hi))
    U32MAX = jnp.uint32(0xFFFFFFFF)
    mlo = jnp.where(keep, lo, U32MAX)
    mhi = jnp.where(keep, hi, U32MAX)
    if out_slots is not None:
        return bottom_k_premasked_planes(
            mlo, mhi, jnp.bool_(sat), s=out_slots, min_cov=1,
            need_counts=True, boost=boost, collect_all=True,
            expected_s=s * boost,
        )
    return bottom_k_premasked_planes(
        mlo, mhi, jnp.bool_(sat), s=s, min_cov=min_cov,
        need_counts=need_counts, boost=boost,
    )

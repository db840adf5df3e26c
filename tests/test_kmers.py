"""The packed lane-parallel DNA k-mer path vs the scalar oracle and the
generic gather formulation (addMinHashes semantics, Sketch.cpp:664-735)."""

import numpy as np
import pytest


def _scalar_kmer_hashes(seq: bytes, k: int, noncanonical: bool, preserve_case: bool, seed: int):
    """Literal per-window oracle: fold case, alphabet filter, canonical
    min(fwd, rc) by memcmp, MurmurHash3 over the ASCII bytes."""
    from fpmash_tpu.scalar.murmur3 import hash_bytes

    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    s = seq if preserve_case else seq.upper()
    out = []
    for i in range(len(s) - k + 1):
        win = s[i : i + k]
        if any(c not in (65, 67, 71, 84) for c in win):
            out.append(None)
            continue
        kmer = win
        if not noncanonical:
            rc = bytes(comp[c] for c in reversed(win))
            if rc < kmer:
                kmer = rc
        out.append(hash_bytes(kmer, seed=seed, use64=True))
    return out


@pytest.mark.parametrize("k", [3, 9, 15, 16, 17, 21, 31, 32])
@pytest.mark.parametrize("noncanonical", [False, True])
def test_acgt_fast_path_matches_scalar(k, noncanonical):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import _kmer_hashes_acgt

    rng = np.random.default_rng(k * 2 + noncanonical)
    chars = np.frombuffer(b"ACGTacgtNACGT", np.uint8)  # mixed case + N
    N = 300
    seq = chars[rng.integers(0, len(chars), N)]
    length = 287  # windows past the valid prefix must be invalid

    h, v = _kmer_hashes_acgt(
        jnp.asarray(seq), jnp.int32(length), k=k,
        noncanonical=noncanonical, preserve_case=False, seed=42,
    )
    h, v = np.asarray(h), np.asarray(v)

    want = _scalar_kmer_hashes(seq.tobytes(), k, noncanonical, False, 42)
    for i in range(N):
        expect_valid = i <= length - k and want[i] is not None
        assert bool(v[i]) == expect_valid, i
        if expect_valid:
            assert int(h[i]) == want[i], i


def test_acgt_fast_path_preserve_case():
    """With -Z, lowercase bases are outside the alphabet -> invalid."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import _kmer_hashes_acgt

    seq = np.frombuffer(b"ACGTacgtACGTACGT", np.uint8)
    h, v = _kmer_hashes_acgt(
        jnp.asarray(seq), jnp.int32(len(seq)), k=4,
        noncanonical=True, preserve_case=True, seed=42,
    )
    v = np.asarray(v)
    want = _scalar_kmer_hashes(seq.tobytes(), 4, True, True, 42)
    for i in range(len(seq) - 4 + 1):
        assert bool(v[i]) == (want[i] is not None), i
        if want[i] is not None:
            assert int(np.asarray(h)[i]) == want[i], i


def test_public_kmer_hashes_routes_acgt():
    """kmer_hashes with the default alphabet must give the fast-path values
    (same result as before the rewrite — reads.msh golden also covers it)."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import _kmer_hashes_acgt, kmer_hashes

    rng = np.random.default_rng(7)
    lut = np.frombuffer(b"ACGT", np.uint8)
    seq = lut[rng.integers(0, 4, 256)]
    h1, v1 = kmer_hashes(jnp.asarray(seq), jnp.int32(256), k=21, seed=42)
    h2, v2 = _kmer_hashes_acgt(
        jnp.asarray(seq), jnp.int32(256), k=21,
        noncanonical=False, preserve_case=False, seed=42,
    )
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))


def test_bottomk_need_counts_false_same_values():
    """need_counts=False (default-CLI sketching) returns the identical
    value set with counts reported as 1 (multiplicities unused)."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.bottomk import bottom_k_threshold

    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << 63, size=1 << 17, dtype=np.uint64)
    pool[100:200] = pool[0]  # duplicates exercise the run-length delta
    valid = np.ones(pool.shape, bool)
    v1, c1, n1, ok1 = bottom_k_threshold(
        jnp.asarray(pool), jnp.asarray(valid), s=1000, need_counts=True
    )
    v2, c2, n2, ok2 = bottom_k_threshold(
        jnp.asarray(pool), jnp.asarray(valid), s=1000, need_counts=False
    )
    assert bool(ok1) and bool(ok2)
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    assert int(n1) == int(n2)
    c2 = np.asarray(c2)
    assert (c2[: int(n2)] == 1).all()

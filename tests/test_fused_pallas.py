"""Fused Duval+MurmurHash3 Triton kernel (interpret mode) vs the scalar
parity chain and the XLA pipeline."""

from __future__ import annotations

import random

import numpy as np
import pytest


def _scalar_hash(word, seed=42, use64=True):
    from fpmash_tpu.scalar.lyndon import cfl
    from fpmash_tpu.scalar.murmur3 import hash_u64_vector

    fac = [len(f) for f in cfl(word)]
    return hash_u64_vector(fac, seed=seed, use64=use64), len(fac)


def _run_batch(batch, lens, seed=42):
    """Kernel over explicit rows: row b is ``batch[b, :lens[b]]``."""
    import jax
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_stream

    B, L = batch.shape
    h, fc = fingerprint_hashes_stream(
        jnp.asarray(batch).reshape(-1), jnp.arange(B, dtype=jnp.int32) * L,
        jnp.asarray(lens), L=L, seed=seed, interpret=True,
    )
    return jax.device_get((h, fc))


def _run_rows(words, seed=42):
    from fpmash_tpu.ops.lyndon import encode_batch

    arr, lens = encode_batch(
        [w.encode("latin-1") if isinstance(w, str) else w for w in words]
    )
    return _run_batch(arr, lens, seed=seed)


def _check(words, seed=42):
    h, fc = _run_rows(words, seed=seed)
    for i, w in enumerate(words):
        want, count = _scalar_hash(w, seed=seed)
        assert int(h[i]) == want, (i, w[:20])
        assert int(fc[i]) == count, (i, w[:20])


@pytest.mark.parametrize("L", [1, 16, 99, 100, 101, 127, 300])
def test_fused_kernel_matches_scalar_chain(L):
    """Every row exactly L wide (1..300: one to ten bitmask words), plus
    the degenerate shapes: maximal factor count, one factor, a last bit
    in the top word."""
    random.seed(L)
    words = ["".join(random.choice("ACGT") for _ in range(L)) for _ in range(40)]
    words += ["A" * L, ("ACGT" * L)[:L], "T" * (L - 1) + "A", ("TGCA" * L)[:L]]
    _check(words)


def test_fused_kernel_ragged_lengths():
    """Mixed row lengths inside one block (short rows finish early)."""
    random.seed(3)
    words = [
        "".join(random.choice("ACGT") for _ in range(random.randint(1, 100)))
        for _ in range(80)
    ]
    words += ["A", "CAAB", "BANANA", "G" * 100]
    _check(words)


def test_fused_kernel_non_acgt_and_lowercase():
    """Bytes compare as unsigned values: lowercase, N, IUPAC codes and
    high bytes factorize like the scalar model's characters."""
    words = ["acgtNNacgtRYKM" * 5, "nnnnACGTacgt", "\xff\x01zzACGT" * 9,
             "ACGTN" * 20, "aaaaAAAA", "TTTTtttt" * 12]
    _check(words)


def test_fused_kernel_zero_length_rows():
    """Empty rows hash the empty factor vector (count 0) and do not
    disturb their neighbours in the block."""
    words = ["", "ACGTTGCA" * 10, "", "", "GATTACA" * 14, ""]
    _check(words)


@pytest.mark.parametrize("B", [1, 31, 33, 95])
def test_fused_kernel_batch_not_multiple_of_block(B):
    """Batch sizes around the 32-window program block: padding rows are
    empty and are sliced off."""
    random.seed(B)
    words = ["".join(random.choice("ACGT") for _ in range(60)) for _ in range(B)]
    h, fc = _run_rows(words)
    assert h.shape == (B,) and fc.shape == (B,)
    _check(words)


def test_fused_kernel_seed_and_low32():
    words = ["GATTACA" * 10, "CCCTTTAAA"]
    h, _ = _run_rows(words, seed=7)
    for i, w in enumerate(words):
        want, _ = _scalar_hash(w, seed=7, use64=False)
        # fp-mode 32-bit truncation rule (Sketch.cpp:1288)
        assert int(h[i]) & 0xFFFFFFFF == want


def test_flat_stream_entry_matches_rows():
    """The stream entry (reads uploaded once, shift windows addressed by
    start offset) == the same windows as explicit rows."""
    import jax
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_stream

    random.seed(23)
    W = 100
    reads = [
        "".join(random.choice("ACGT") for _ in range(random.randint(W, 180)))
        for _ in range(3)
    ]
    stream, starts, wins = b"", [], []
    for seq in reads:
        dbl = seq + seq[: W - 1]
        starts.extend(len(stream) + i for i in range(len(seq)))
        wins.extend(dbl[i : i + W] for i in range(len(seq)))
        stream += dbl.encode()
    lens = np.full(len(wins), W, np.int32)
    hs, fs = jax.device_get(
        fingerprint_hashes_stream(
            jnp.asarray(np.frombuffer(stream, np.uint8)),
            jnp.asarray(np.array(starts, np.int32)), jnp.asarray(lens),
            L=W, seed=42, interpret=True,
        )
    )
    batch = np.frombuffer("".join(wins).encode(), np.uint8).reshape(-1, W)
    hr, fr = _run_batch(batch, lens)
    assert np.array_equal(hs, hr) and np.array_equal(fs, fr)
    for b in (0, len(wins) // 2, len(wins) - 1):
        assert int(hs[b]) == _scalar_hash(wins[b])[0]


def test_fused_kernel_matches_xla_pipeline():
    """Kernel == ``cfl_lengths_onehot`` + ``murmur3_u64_batch`` (the CPU
    route) on random windows."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.lyndon import cfl_lengths_onehot
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    rng = np.random.default_rng(9)
    batch = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(64, 100))]
    lens = rng.integers(0, 101, size=64).astype(np.int32)
    h, fc = _run_batch(batch, lens)
    fl, fc2 = cfl_lengths_onehot(jnp.asarray(batch), jnp.asarray(lens))
    h2, _ = murmur3_u64_batch(fl.astype(jnp.uint64), fc2, seed=42)
    assert np.array_equal(h, np.asarray(h2))
    assert np.array_equal(fc, np.asarray(fc2))


def test_fused_kernel_rejects_too_wide_rows():
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import MAX_L, fingerprint_hashes_stream

    with pytest.raises(ValueError, match="window width"):
        fingerprint_hashes_stream(
            jnp.zeros(4096, jnp.uint8), jnp.zeros(4, jnp.int32),
            jnp.zeros(4, jnp.int32), L=MAX_L + 1,
        )


@pytest.mark.parametrize("L", [100, 512])
def test_fused_kernel_lowers_to_triton(L):
    """The kernel lowers to Triton IR for CUDA (no card needed: this is
    the Pallas lowering the GPU compile starts from)."""
    import jax
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_stream

    lowered = (
        jax.jit(lambda s, st, ln: fingerprint_hashes_stream(s, st, ln, L=L))
        .trace(
            jnp.zeros(1 << 16, jnp.uint8), jnp.zeros(96, jnp.int32),
            jnp.zeros(96, jnp.int32),
        )
        .lower(lowering_platforms=("cuda",))
    )
    assert "triton" in lowered.as_text()

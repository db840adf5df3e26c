"""Sharded pipeline correctness on the virtual 8-device CPU mesh."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mesh():
    import jax

    from fpmash_tpu.parallel.mesh import default_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return default_mesh(8)


def test_sharded_fingerprint_hashes_match_single(mesh):
    import jax.numpy as jnp

    from fpmash_tpu.ops.lyndon import cfl_lengths
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch
    from fpmash_tpu.parallel.sharded import sharded_fingerprint_hashes

    rng = np.random.default_rng(2)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, L = 64, 40
    w = lut[rng.integers(0, 4, size=(B, L))]
    lens = np.full((B,), L, np.int32)

    sharded = np.asarray(
        sharded_fingerprint_hashes(mesh, jnp.asarray(w), jnp.asarray(lens))
    )
    fac_len, fac_count = cfl_lengths(jnp.asarray(w), jnp.asarray(lens))
    single, _ = murmur3_u64_batch(fac_len.astype(jnp.uint64), fac_count, seed=42)
    assert np.array_equal(sharded, np.asarray(single))


def test_sharded_bottom_k_matches_host(mesh):
    import jax.numpy as jnp

    from fpmash_tpu.ops.bottomk import bottom_k_host
    from fpmash_tpu.parallel.sharded import sharded_bottom_k

    rng = np.random.default_rng(3)
    pool = rng.integers(1, 1000, size=4096, dtype=np.uint64)
    s = 32
    got = np.asarray(
        sharded_bottom_k(mesh, jnp.asarray(pool), jnp.ones(4096, bool), s)
    )
    exp, _ = bottom_k_host(pool, s)
    got = got[got != np.uint64(0xFFFFFFFFFFFFFFFF)]
    assert np.array_equal(got, exp)


def test_sharded_all_pairs_matches_single(mesh):
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import pairwise_common_denom
    from fpmash_tpu.parallel.sharded import sharded_all_pairs

    rng = np.random.default_rng(4)
    S = 64
    R, Q = 4, 16
    ref = np.sort(rng.integers(1, 10000, size=(R, S), dtype=np.uint64), axis=1)
    qry = np.sort(rng.integers(1, 10000, size=(Q, S), dtype=np.uint64), axis=1)
    # de-dup within rows to satisfy the kernel's distinctness contract
    ref = np.sort(np.unique(rng.integers(1, 10**9, size=(R, S * 2), dtype=np.uint64))[:S])[None, :].repeat(R, 0)
    qry = np.stack([
        np.sort(rng.choice(np.arange(1, 10**6, dtype=np.uint64), S, replace=False))
        for _ in range(Q)
    ])
    ref = np.stack([
        np.sort(rng.choice(np.arange(1, 10**6, dtype=np.uint64), S, replace=False))
        for _ in range(R)
    ])
    rl = np.full((R,), S, np.int32)
    ql = np.full((Q,), S, np.int32)

    c_sh, d_sh = sharded_all_pairs(
        mesh, jnp.asarray(ref), jnp.asarray(rl), jnp.asarray(qry), jnp.asarray(ql), S
    )
    c_1, d_1 = pairwise_common_denom(
        jnp.asarray(ref), jnp.asarray(rl), jnp.asarray(qry), jnp.asarray(ql), sketch_size=S
    )
    assert np.array_equal(np.asarray(c_sh), np.asarray(c_1))
    assert np.array_equal(np.asarray(d_sh), np.asarray(d_1))


def test_graft_entry_and_dryrun():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (args[0].shape[0],)
    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)


@pytest.mark.slow
def test_sharded_step_collective_counts_d_independent():
    """Structural scaling proxy (VERDICT r4 #7): the wall-clock floor test
    below cannot distinguish 'slow because shared cores' from 'slow
    because a collective serialized'.  This asserts the properties a
    virtual mesh CAN check exactly: (a) the compiled pipeline step
    contains a D-INDEPENDENT number of collectives (a regression that
    unrolls a collective into per-device loops changes the count), and
    (b) re-executing the warm step triggers zero recompiles."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from fpmash_tpu.parallel.mesh import default_mesh
    from fpmash_tpu.parallel.sharded import pipeline_step

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", np.uint8)
    B, L, S = 16, 40, 8
    w = jnp.asarray(lut[rng.integers(0, 4, (B, L))])
    lens = jnp.full((B,), L, jnp.int32)
    # ref rows shard over dp in the step's final tile: divisible by 8
    ref = jnp.asarray(
        np.sort(rng.integers(1, 1 << 40, (8, S), dtype=np.uint64), axis=1)
    )
    rl = jnp.full((8,), S, jnp.int32)

    counts = {}
    for D in (2, 4, 8):
        f = jax.jit(partial(pipeline_step, default_mesh(D), sketch_size=S))
        txt = f.lower(w, lens, ref, rl).compile().as_text()
        counts[D] = {
            op: txt.count(op)
            for op in ("all-gather", "all-reduce", "collective-permute", "all-to-all")
        }
        jax.block_until_ready(f(w, lens, ref, rl))
        size_before = f._cache_size()
        jax.block_until_ready(f(w, lens, ref, rl))
        assert f._cache_size() == size_before, f"warm step recompiled at D={D}"
    assert counts[2] == counts[4] == counts[8], counts
    assert sum(counts[8].values()) > 0, "no collectives found in the step"

"""Device-route selection: one platform rule (``fpmash_tpu.route``), and
each route it picks checked against the CPU route or the host models.

The CPU suite cannot compile for the GPU, so the GPU routes are driven
here with the route rule patched to ``gpu`` and the Triton kernel in
interpret mode; ``chip_smoke.py`` runs them compiled on the card.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fpmash_tpu import route


@pytest.mark.parametrize(
    "op, cpu, gpu",
    [
        ("cfl_kernel", "xla", "triton"),
        ("chunk_bases", 1 << 15, 1 << 22),
        ("compare_tile", 128, 256),
    ],
)
def test_route_rule_per_platform(op, cpu, gpu):
    fn = getattr(route, op)
    assert fn("cpu") == cpu
    assert fn("gpu") == gpu


@pytest.mark.parametrize(
    "op", ["platform", "cfl_kernel", "chunk_bases", "compare_tile"]
)
def test_route_rule_rejects_unknown_platform(op):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        getattr(route, op)("metal")


def test_route_rule_reads_the_active_backend():
    assert route.platform() == "cpu"
    assert route.cfl_kernel() == "xla"


def test_default_backend_is_read_in_one_module():
    """No other module makes the platform decision itself."""
    root = pathlib.Path(route.__file__).parent
    readers = sorted(
        str(p.relative_to(root))
        for p in root.rglob("*.py")
        if "default_backend" in p.read_text()
    )
    assert readers == ["route.py"]


def _gpu_cfl_route(monkeypatch):
    """Patch the route rule to the GPU's CFL choice and run the Triton
    kernel interpreted; returns the list of kernel calls."""
    from fpmash_tpu.ops import fused_pallas

    calls = []
    orig = fused_pallas.fingerprint_hashes_stream

    def spy(*a, **kw):
        calls.append(kw["L"])
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(route, "cfl_kernel", lambda name=None: "triton")
    monkeypatch.setattr(fused_pallas, "fingerprint_hashes_stream", spy)
    return calls


def _reads(lengths, seed):
    rng = np.random.default_rng(seed)
    return [
        (f"r{i}", "".join("ACGT"[c] for c in rng.integers(0, 4, size=n)))
        for i, n in enumerate(lengths)
    ]


def _sketch_fp(reads, shift=True, family="CFL"):
    from fpmash_tpu.models.sketch import Sketch, SketchParams

    sk = Sketch(SketchParams().for_fingerprint())
    sk.init_from_reads_fingerprint(list(reads), family, shift=shift)
    return sk


def _assert_same_sketch(got, want):
    assert len(got.references) == len(want.references)
    for a, b in zip(got.references, want.references):
        assert a.name == b.name and a.length == b.length
        assert np.array_equal(
            np.asarray(a.hashes, np.uint64), np.asarray(b.hashes, np.uint64)
        )


@pytest.mark.parametrize("shift", [True, False])
def test_sketch_cfl_gpu_route_matches_cpu_route(monkeypatch, shift):
    """On the GPU route, --direct-fp CFL goes through the Triton kernel and
    is bit-identical to the CPU route (XLA Duval + murmur)."""
    reads = _reads((120, 215, 101), seed=31)
    want = _sketch_fp(reads, shift=shift)
    monkeypatch.setenv("FPMASH_DEVICES", "1")
    calls = _gpu_cfl_route(monkeypatch)
    got = _sketch_fp(reads, shift=shift)
    assert calls == [100 if shift else 215], "Triton route not taken"
    _assert_same_sketch(got, want)


def test_sketch_cfl_gpu_route_short_and_empty_reads(monkeypatch):
    """Reads shorter than the 100-base shift window (incl. zero-length)
    are one row each, addressed in the same stream as the full reads."""
    reads = _reads((120, 0, 50, 101, 7), seed=33)
    want = _sketch_fp(reads)
    monkeypatch.setenv("FPMASH_DEVICES", "1")
    calls = _gpu_cfl_route(monkeypatch)
    got = _sketch_fp(reads)
    assert calls, "Triton route not taken"
    _assert_same_sketch(got, want)


def test_sketch_cfl_gpu_route_too_wide_rows_use_xla(monkeypatch):
    """Rows wider than the kernel's MAX_L take the XLA route."""
    from fpmash_tpu.ops.fused_pallas import MAX_L

    reads = _reads((MAX_L + 40, 90), seed=35)
    want = _sketch_fp(reads, shift=False)
    monkeypatch.setenv("FPMASH_DEVICES", "1")
    calls = _gpu_cfl_route(monkeypatch)
    got = _sketch_fp(reads, shift=False)
    assert not calls
    _assert_same_sketch(got, want)


def test_sketch_cfl_gpu_route_multidevice(monkeypatch):
    """With several devices the kernel runs under shard_map (window rows
    sharded, the read stream replicated), bit-identical to one device."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    reads = _reads((130, 140, 100, 0), seed=37)
    want = _sketch_fp(reads)
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    calls = _gpu_cfl_route(monkeypatch)
    got = _sketch_fp(reads)
    assert calls
    _assert_same_sketch(got, want)


def test_classic_direct_route_multichunk(monkeypatch):
    """The fused direct classic route (chunked classic_sketch_device +
    host-side bottom-k merge) produces the identical sketch to the pool
    path, including across chunk boundaries and with duplicate k-mers."""
    from fpmash_tpu.models import sketch as sk
    from fpmash_tpu.ops.bottomk import bottom_k_host

    rng = np.random.default_rng(41)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=20000))
    seq = seq[:5000] + seq[:5000] + seq[10000:]  # duplicated region
    p = sk.SketchParams(kmer_size=21, sketch_size=64)
    wv, wc = bottom_k_host(sk._kmer_hash_pool([seq], p, "auto"), 64)

    monkeypatch.setenv("FPMASH_DEVICES", "1")
    monkeypatch.setattr(sk, "_DIRECT_CHUNK", 8192)  # forces 3+ chunks
    got = sk._classic_sketch_direct([seq], p, "auto")
    assert got is not None, "direct route not taken"
    gv, gc = got
    assert np.array_equal(gv, wv)
    assert (gc == 1).all()  # multiplicities unused -> ones contract

    # multi-device round-robin (chunks across the 8-virtual-device mesh)
    # must be byte-identical to the single-device run
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    got8 = sk._classic_sketch_direct([seq], p, "auto")
    assert got8 is not None
    assert np.array_equal(got8[0], wv)
    monkeypatch.setenv("FPMASH_DEVICES", "1")

    # with -M the counts are consumed: exact multiplicities must merge
    # across chunks (the duplicated region's k-mers have count 2 split
    # between chunks)
    p2 = sk.SketchParams(kmer_size=21, sketch_size=64, counts=True)
    got2 = sk._classic_sketch_direct([seq], p2, "auto")
    assert got2 is not None
    gv2, gc2 = got2
    assert np.array_equal(gv2, wv)
    assert np.array_equal(gc2.astype(np.uint32), wc)


def test_direct_reads_mode_route_multichunk(monkeypatch):
    """min_cov=2 reads-mode direct route (collect-all chunks + merged
    counts + post-merge filter) == the exact pool path, including values
    whose copies are split across chunk boundaries."""
    from fpmash_tpu.models import sketch as sk
    from fpmash_tpu.ops.bottomk import bottom_k_host

    monkeypatch.setenv("FPMASH_DEVICES", "1")
    monkeypatch.setattr(sk, "_DIRECT_CHUNK", 8192)
    rng = np.random.default_rng(47)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, size=9000))
    # copies of the first 9k land in chunks 0/1 and 2/3: min_cov=2
    # admission only works if counts merge across chunks
    seq = base + "".join("ACGT"[c] for c in rng.integers(0, 4, size=3000)) + base
    p = sk.SketchParams(kmer_size=21, sketch_size=64, min_cov=2, reads=True,
                        counts=True)
    want_v, want_c = bottom_k_host(sk._kmer_hash_pool([seq], p, "auto"), 64, 2)
    assert len(want_v) == 64  # the duplicated region provides plenty

    got = sk._classic_sketch_direct([seq], p, "auto")
    assert got is not None, "reads-mode direct route not taken"
    gv, gc = got
    assert np.array_equal(gv, want_v)
    assert np.array_equal(gc.astype(np.uint32), want_c)

    # multi-device round-robin parity
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    got8 = sk._classic_sketch_direct([seq], p, "auto")
    assert got8 is not None
    assert np.array_equal(got8[0], want_v)
    assert np.array_equal(got8[1].astype(np.uint32), want_c)

    # a low-multiplicity pool (few values reach min_cov): the ladder must
    # either produce the exact (short) result via saturation or fall back
    # with None — never a wrong sketch
    seq2 = "".join("ACGT"[c] for c in rng.integers(0, 4, size=20000))
    monkeypatch.setenv("FPMASH_DEVICES", "1")
    w2v, w2c = bottom_k_host(sk._kmer_hash_pool([seq2], p, "auto"), 64, 2)
    got2 = sk._classic_sketch_direct([seq2], p, "auto")
    if got2 is not None:
        assert np.array_equal(got2[0], w2v)
        assert np.array_equal(got2[1].astype(np.uint32), w2c)


def test_classic_direct_route_tail_sliver_and_chunk_fallback(monkeypatch):
    """Two-phase dispatch: (a) a tail sliver shorter than k is skipped
    without sinking the route; (b) a chunk that fails the boost ladder
    (here: nearly all-N) falls back to an exact pool pass over just that
    chunk instead of abandoning all completed chunk work."""
    from fpmash_tpu.models import sketch as sk
    from fpmash_tpu.ops.bottomk import bottom_k_host

    monkeypatch.setenv("FPMASH_DEVICES", "1")
    monkeypatch.setattr(sk, "_DIRECT_CHUNK", 8192)
    rng = np.random.default_rng(43)
    step = 8192 - 20
    # chunk 0 random, chunk 1 nearly all N (fails the ladder), tail
    # sliver of k-2 bases (zero possible windows -> skipped)
    seq = (
        "".join("ACGT"[c] for c in rng.integers(0, 4, size=step))
        + "N" * (step - 40)
        + "".join("ACGT"[c] for c in rng.integers(0, 4, size=40))
        + "".join("ACGT"[c] for c in rng.integers(0, 4, size=19))
    )
    p = sk.SketchParams(kmer_size=21, sketch_size=64)
    got = sk._classic_sketch_direct([seq], p, "auto")
    assert got is not None, "direct route abandoned despite usable chunks"
    want = bottom_k_host(sk._kmer_hash_pool([seq], p, "auto"), 64)[0]
    assert np.array_equal(got[0], want)


def test_classic_direct_route_all_invalid(monkeypatch):
    """An all-N sequence (no valid windows) must not crash the direct
    route's merge (saturated-empty chunks return ok with 0 candidates)."""
    from fpmash_tpu.models import sketch as sk

    monkeypatch.setenv("FPMASH_DEVICES", "1")
    monkeypatch.setattr(sk, "_DIRECT_CHUNK", 8192)
    p = sk.SketchParams(kmer_size=21, sketch_size=64)
    got = sk._classic_sketch_direct(["N" * 20000], p, "auto")
    if got is not None:  # either outcome valid; must not raise
        gv, gc = got
        assert len(gv) == 0


@pytest.mark.parametrize("k", [21, 15])
def test_screen_distinct_counts_device_route(k):
    """screen's query-side distinct counting on device (sort + run-length
    + prefix download) == host np.unique over the pool, incl. duplicates,
    invalid characters, record separators, and (k=15: 32-bit hashes) the
    collapse of the high hash word."""
    from fpmash_tpu.models import sketch as sk

    rng = np.random.default_rng(53)
    chars = np.array(list("ACGTN"))
    seqs = [
        "".join(rng.choice(chars, 40000, p=[0.24, 0.24, 0.24, 0.24, 0.04])),
        "".join(rng.choice(chars, 30000, p=[0.25] * 4 + [0.0])),
    ]
    seqs.append(seqs[1][:20000])  # heavy duplication across records
    p = sk.SketchParams(kmer_size=k)
    assert p.use64 == (k > 16)
    want_v, want_c = np.unique(
        np.asarray(sk._kmer_hash_pool(seqs, p, "auto"), np.uint64),
        return_counts=True,
    )
    got_v, got_c = sk._kmer_distinct_counts(seqs, p, "auto")
    assert np.array_equal(got_v, want_v)
    assert np.array_equal(got_c.astype(np.int64), want_c)


def test_bottom_k_under_collection_falls_back_to_full_sort(monkeypatch):
    """The threshold bottom-k's ``ok`` flag (a data condition: the filter
    under-collected) sends the pool to the exact full-sort kernel."""
    from fpmash_tpu.models import sketch as sk
    from fpmash_tpu.ops import bottomk as bk

    rng = np.random.default_rng(51)
    # > 1<<17 after the pow2 bucket so the threshold fast path is taken
    pool = rng.integers(1, 1 << 63, size=(1 << 17) + 1, dtype=np.uint64)
    p = sk.SketchParams(sketch_size=64)
    want_v, want_c = bk.bottom_k_host(pool, 64)
    calls = []
    orig = bk.bottom_k_threshold

    def never_ok(*a, **kw):
        calls.append(kw["boost"])
        v, c, n, ok = orig(*a, **kw)
        return v, c, n, jnp.bool_(False)

    monkeypatch.setattr(bk, "bottom_k_threshold", never_ok)
    v, c = sk._bottom_k(pool, p, "jax")
    assert calls == [1, 8]
    assert np.array_equal(v, want_v) and np.array_equal(c, want_c)


def test_compare_gpu_tile_matches_cpu_tile(monkeypatch):
    """The GPU's compare tile size changes only the tiling, not results."""
    from fpmash_tpu.ops.compare import all_pairs_common_denom

    rng = np.random.default_rng(2)
    sk = [np.unique(rng.integers(0, 1 << 20, size=60, dtype=np.uint64))[:40]
          for _ in range(300)]
    want = all_pairs_common_denom(sk[:20], sk, 40)
    monkeypatch.setattr(route, "compare_tile", lambda name=None: 256)
    got = all_pairs_common_denom(sk[:20], sk, 40)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

"""Unsorted merge-join walk kernel: equivalence with the literal walk.

The reference runs compareSketches' order-dependent merge-join over
fingerprint hash lists in FILE order (CommandDistance.cpp:376-400 fed by
initFromFingerprints, Sketch.cpp:56-151).  ops/walk.py steps the same
automaton for all pairs of a tile in lockstep; these tests pin it to the
literal Python walk (models/distance.py:51) on adversarially unsorted
inputs, and pin the `dist -fp` routing through it.
"""

import random

import numpy as np
import pytest

from fpmash_tpu.models.distance import compare_sketches
from fpmash_tpu.ops.walk import all_pairs_walk


def _rand_list(rng, n, dup_pool=50):
    # small value pool forces duplicates and equal-element steps
    return rng.integers(0, dup_pool, size=n).astype(np.uint64)


@pytest.mark.parametrize("S", [4, 17, 100])
def test_walk_kernel_equals_literal_walk(S):
    rng = np.random.default_rng(S)
    refs = [_rand_list(rng, int(rng.integers(0, 2 * S + 1))) for _ in range(7)]
    qrys = [_rand_list(rng, int(rng.integers(0, 2 * S + 1))) for _ in range(5)]
    common, denom = all_pairs_walk(refs, qrys, S)
    for ri, A in enumerate(refs):
        for qi, B in enumerate(qrys):
            res = compare_sketches(A, B, 100, 100, S, 21, 4.0**21)
            assert (common[ri, qi], denom[ri, qi]) == (res.numer, res.denom), (ri, qi)


def test_walk_kernel_sorted_inputs_match_sorted_kernel():
    """On sorted distinct lists the walk kernel and the closed-form batch
    kernel must agree (they are the same semantics)."""
    from fpmash_tpu.ops.compare import all_pairs_common_denom

    rng = np.random.default_rng(3)
    S = 64
    refs = [np.sort(rng.choice(10**6, int(rng.integers(1, S + 1)), replace=False).astype(np.uint64)) for _ in range(6)]
    qrys = [np.sort(rng.choice(10**6, int(rng.integers(1, S + 1)), replace=False).astype(np.uint64)) for _ in range(6)]
    c1, d1 = all_pairs_walk(refs, qrys, S)
    c2, d2 = all_pairs_common_denom(refs, qrys, S)
    assert np.array_equal(c1, c2) and np.array_equal(d1, d2)


def test_walk_tiled_matches_untiled():
    rng = np.random.default_rng(11)
    refs = [_rand_list(rng, int(rng.integers(1, 40))) for _ in range(33)]
    qrys = [_rand_list(rng, int(rng.integers(1, 40))) for _ in range(21)]
    c1, d1 = all_pairs_walk(refs, qrys, 30)
    c2, d2 = all_pairs_walk(refs, qrys, 30, tile=8)
    assert np.array_equal(c1, c2) and np.array_equal(d1, d2)


def test_walk_empty_lists():
    refs = [np.array([], np.uint64), np.array([5, 3], np.uint64)]
    qrys = [np.array([3], np.uint64), np.array([], np.uint64)]
    common, denom = all_pairs_walk(refs, qrys, 10)
    for ri, A in enumerate(refs):
        for qi, B in enumerate(qrys):
            res = compare_sketches(A, B, 10, 10, 10, 21, 4.0**21)
            assert (common[ri, qi], denom[ri, qi]) == (res.numer, res.denom)


def test_dist_routes_unsorted_through_walk_kernel(monkeypatch):
    """all_pairs_dist with unsorted sketches must produce byte-identical
    results to the scalar backend AND actually take the device walk path."""
    from fpmash_tpu.models.distance import all_pairs_dist
    from fpmash_tpu.models.sketch import Reference, Sketch, SketchParams

    rng = np.random.default_rng(7)

    def mk_sketch(n):
        sk = Sketch()
        sk.params = SketchParams(
            kmer_size=1, sketch_size=50, alphabet="0123456789", noncanonical=True
        )
        for i in range(n):
            h = _rand_list(rng, int(rng.integers(2, 60)), dup_pool=1000)
            sk.references.append(
                Reference(name=f"r{i}", comment="", length=100, hashes=h)
            )
        return sk

    ref, qry = mk_sketch(9), mk_sketch(10)

    calls = []
    import fpmash_tpu.ops.walk as walk_mod

    orig = walk_mod.all_pairs_walk

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(walk_mod, "all_pairs_walk", spy)

    dev = [(ri, qi, r.numer, r.denom, r.distance, r.pvalue)
           for ri, qi, r in all_pairs_dist(ref, qry, backend="jax")]
    sca = [(ri, qi, r.numer, r.denom, r.distance, r.pvalue)
           for ri, qi, r in all_pairs_dist(ref, qry, backend="scalar")]
    assert dev == sca
    assert calls, "unsorted dist did not route through the walk kernel"

"""Factorization parity: scalar models and the batched Duval kernel."""

import random

import pytest

from fpmash_tpu.scalar.lyndon import (
    cfl,
    cfl_icfl,
    d_cfl,
    d_cfl_icfl,
    d_icfl,
    icfl,
    reverse_complement,
)


def test_cfl_textbook_cases():
    assert cfl("banana") == ["b", "an", "an", "a"]
    assert cfl("AAAA") == ["A", "A", "A", "A"]
    assert cfl("ACGT") == ["ACGT"]
    assert cfl("TGCA") == ["T", "G", "C", "A"]
    assert cfl("A") == ["A"]
    # concatenation invariant + non-increasing Lyndon factors
    w = "GATTACACATTAGGA"
    fac = cfl(w)
    assert "".join(fac) == w
    assert all(fac[i] >= fac[i + 1] for i in range(len(fac) - 1))


def _is_inverse_lyndon(w: str) -> bool:
    # w is an inverse Lyndon word iff every proper suffix is << -smaller:
    # s <' w (prefix order): s is a proper prefix of w, or s < w at the
    # first differing character.
    for s in (w[i:] for i in range(1, len(w))):
        if w.startswith(s):
            continue
        if s > w:
            return False
    return True


def test_icfl_properties():
    random.seed(5)
    for _ in range(300):
        w = "".join(random.choice("ACGT") for _ in range(random.randint(1, 80)))
        fac = icfl(w)
        assert "".join(fac) == w
        for f in fac:
            assert _is_inverse_lyndon(f), (w, fac, f)


def test_cfl_icfl_markers():
    w = "A" * 40  # one long CFL run of 'A' factors, each short
    assert cfl_icfl(w, 10, sep=True) == ["A"] * 40
    # a long Lyndon factor gets sub-factorized and wrapped
    w = "ACGTACGTACGTACGTACGG"[:-1] + "T"  # len 20 Lyndon-ish
    out = cfl_icfl("A" + "C" * 25, 10, sep=True)
    assert out[0] == "<<" and out[-1] == ">>"
    assert "".join(f for f in out if f not in ("<<", ">>")) == "A" + "C" * 25


def test_comb_concatenation():
    random.seed(6)
    for _ in range(200):
        w = "".join(random.choice("ACGT") for _ in range(random.randint(1, 120)))
        for fn in (d_cfl, d_icfl, lambda s: d_cfl_icfl(s, 10)):
            fac = fn(w)
            assert "".join(fac) == w


def test_reverse_complement():
    assert reverse_complement("ACGT") == "ACGT"
    assert reverse_complement("AACG") == "CGTT"
    assert reverse_complement("N") == "N"


@pytest.mark.parametrize("kernel", ["scan", "sa", "onehot", "cmp"])
def test_device_duval_matches_scalar(kernel):
    import jax
    import jax.numpy as jnp

    from fpmash_tpu.ops import lyndon as lyn

    random.seed(13)
    words = ["".join(random.choice("ACGT") for _ in range(random.randint(1, 120))) for _ in range(150)]
    words += ["A" * 100, "ACGT" * 25, "T" * 7 + "A", "A", "TTTT", "CAAAAAAB", "BANANA"]
    arr, lens = lyn.encode_batch(words)
    fn = {"scan": lyn.cfl_lengths, "sa": lyn.cfl_lengths_sa, "onehot": lyn.cfl_lengths_onehot, "cmp": lyn.cfl_lengths_cmp}[kernel]
    fl, fc = jax.device_get(fn(jnp.asarray(arr), jnp.asarray(lens)))
    for i, w in enumerate(words):
        assert list(map(int, fl[i, : fc[i]])) == [len(f) for f in cfl(w)], w

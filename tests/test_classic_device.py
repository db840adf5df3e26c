"""The XLA classic sketch (``ops.kmers.classic_sketch_device``) against the
host models: ``_kmer_hash_pool_scalar`` (per-k-mer MurmurHash3 of the
canonical k-mer) + ``bottom_k_host`` (np.unique bottom-s)."""

from __future__ import annotations

import numpy as np
import pytest

N = 1 << 14
S = 64


def _seq(seed, n=N - 700, dup=True):
    """Random DNA with lowercase runs, N runs, and (dup) a repeated
    region so some k-mers occur more than once."""
    rng = np.random.default_rng(seed)
    s = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
    s = s[:3000] + s[3000:3400].lower() + "N" * 30 + s[3430:]
    if dup:
        s = s[: n // 2] + s[: n // 4] + s[n // 2 + n // 4 :]
    return s[:n]


def _device(seq, **kw):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import classic_sketch_device

    buf = np.zeros(N, np.uint8)
    buf[: len(seq)] = np.frombuffer(seq.encode(), np.uint8)
    v, c, n, ok = classic_sketch_device(
        jnp.asarray(buf), jnp.int32(len(seq)), **kw
    )
    n = int(n)
    return np.asarray(v)[:n], np.asarray(c)[:n], bool(ok)


def _host(seq, k, noncanonical):
    from fpmash_tpu.models.sketch import SketchParams, _kmer_hash_pool_scalar

    p = SketchParams(kmer_size=k, noncanonical=noncanonical)
    return np.unique(_kmer_hash_pool_scalar([seq], p), return_counts=True)


@pytest.mark.parametrize("need_counts", [False, True])
@pytest.mark.parametrize("noncanonical", [False, True])
@pytest.mark.parametrize("k", [17, 21, 31, 32])
def test_classic_sketch_device_matches_host(k, noncanonical, need_counts):
    seq = _seq(k)
    v, c, ok = _device(
        seq, k=k, s=S, noncanonical=noncanonical, seed=42,
        need_counts=need_counts,
    )
    hv, hc = _host(seq, k, noncanonical)
    assert ok
    assert np.array_equal(v, hv[:S])
    if need_counts:
        assert np.array_equal(c, hc[:S].astype(np.uint32))
    else:
        assert (c == 1).all()


def test_classic_sketch_device_min_cov():
    """min_cov admission inside one chunk: only values seen >= 2 times."""
    seq = _seq(5)
    v, c, ok = _device(seq, k=21, s=S, seed=42, min_cov=2, boost=2)
    hv, hc = _host(seq, 21, False)
    keep = hc >= 2
    assert ok
    assert np.array_equal(v, hv[keep][:S])
    assert np.array_equal(c, hc[keep][:S].astype(np.uint32))


def test_classic_sketch_device_reads_collect_all():
    """Reads-mode collect-all contract: EVERY sub-threshold value comes
    back with its exact count (min_cov is the caller's, after the
    cross-chunk merge), so the result is an exact prefix of the host's
    distinct values."""
    seq = _seq(7)
    v, c, ok = _device(seq, k=21, s=S, seed=42, out_slots=16 * S)
    hv, hc = _host(seq, 21, False)
    assert ok and len(v) >= S
    assert np.array_equal(v, hv[: len(v)])
    assert np.array_equal(c, hc[: len(v)].astype(np.uint32))


def test_classic_sketch_device_rejects_short_k():
    with pytest.raises(ValueError, match="16 < k <= 32"):
        _device(_seq(1), k=16, s=S)


def test_classic_direct_multichunk_counts_k31(monkeypatch):
    """Chunked direct route at k=31 with counts: per-chunk bottom-k merged
    on the host == one host bottom-k over the whole sequence."""
    from fpmash_tpu.models import sketch as sk
    from fpmash_tpu.ops.bottomk import bottom_k_host

    monkeypatch.setenv("FPMASH_DEVICES", "1")
    monkeypatch.setattr(sk, "_DIRECT_CHUNK", 8192)
    seq = _seq(11, n=30000)
    p = sk.SketchParams(kmer_size=31, sketch_size=S, counts=True)
    got = sk._classic_sketch_direct([seq], p, "auto")
    assert got is not None
    wv, wc = bottom_k_host(sk._kmer_hash_pool_scalar([seq], p), S)
    assert np.array_equal(got[0], wv)
    assert np.array_equal(got[1].astype(np.uint32), wc)

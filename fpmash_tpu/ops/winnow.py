"""Windowed min-hash ("minmer") selection — batched device kernel.

Batched device replacement for the reference's incremental sliding-window
structure (``getMinHashPositions``, Sketch.cpp:737-1047).  The incremental
map/deque algorithm is inherently serial; property testing (see
``tests/test_winnow.py``) shows it is exactly equivalent to this
declarative formulation, which vectorizes cleanly:

    position ``p`` is a minmer  iff  some full window ``W`` of
    ``window_size`` consecutive k-mer positions contains ``p`` such that
      * ``h[p]`` is among the bottom ``mins`` *distinct* hash values of
        ``W`` (all values qualify if ``W`` has fewer than ``mins``
        distinct), and
      * ``p`` is the earliest occurrence of ``h[p]`` within ``W``.

The kernel processes window starts in fixed-size chunks: gather the
``[C, ws]`` window matrix, sort each row, take the ``mins``-th distinct
value as the row threshold, test each entry against the threshold and
against its previous-occurrence index (first-in-window test), and
scatter-OR the qualifying flags back to position space.  Every shape is
static.
"""

from __future__ import annotations

from functools import partial

import numpy as np

_U64_MAX = 0xFFFFFFFFFFFFFFFF


def _prev_occurrence(h: np.ndarray) -> np.ndarray:
    """prev[p] = largest q < p with h[q] == h[p], else -1."""
    n = len(h)
    order = np.argsort(h, kind="stable")
    prev = np.full(n, -1, np.int64)
    if n > 1:
        same = h[order[1:]] == h[order[:-1]]
        prev[order[1:][same]] = order[:-1][same]
    return prev


def _chunk_marks_np(h, prev, starts, ws, mins):
    """Qualifying (index, flag) marks for one chunk of window starts."""
    idx = starts[:, None] + np.arange(ws, dtype=np.int64)[None, :]
    win = h[idx]
    srt = np.sort(win, axis=1)
    first = np.ones(srt.shape, bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = np.cumsum(first, axis=1)
    kth = np.where(first & (rank == mins), srt, 0)
    t = kth.max(axis=1)
    t[rank[:, -1] < mins] = np.uint64(_U64_MAX)
    qual = (win <= t[:, None]) & (prev[idx] < starts[:, None])
    return idx, qual


def minmer_positions(
    hashes: np.ndarray, window_size: int, mins: int, backend: str = "auto"
) -> tuple[np.ndarray, np.ndarray]:
    """Minmer ``(positions u32, hashes u64)`` of per-position ``hashes``.

    Equivalent to the reference's ``getMinHashPositions`` output order
    (one entry per minmer position, ascending).
    """
    h = np.ascontiguousarray(hashes, np.uint64)
    n = len(h)
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint64)
    ws = min(window_size, n)
    num_w = n - ws + 1
    prev = _prev_occurrence(h)
    mark = np.zeros(n, bool)

    use_jax = backend == "jax" or (backend == "auto" and n * ws >= 1 << 22)
    if use_jax:
        import jax.numpy as jnp

        C = max(1, min(num_w, (1 << 22) // ws))
        hj = jnp.asarray(h)
        pj = jnp.asarray(prev)
        for w0 in range(0, num_w, C):
            idx, qual = _chunk_marks_jax(
                hj, pj, w0, num_w, ws=ws, mins=mins, C=C
            )
            np.logical_or.at(mark, np.asarray(idx), np.asarray(qual))
    else:
        C = max(1, min(num_w, (1 << 20) // ws))
        for w0 in range(0, num_w, C):
            starts = np.arange(w0, min(w0 + C, num_w), dtype=np.int64)
            idx, qual = _chunk_marks_np(h, prev, starts, ws, mins)
            np.logical_or.at(mark, idx, qual)

    pos = np.nonzero(mark)[0].astype(np.uint32)
    return pos, h[pos]


def _chunk_marks_jax(h, prev, w0, num_w, *, ws: int, mins: int, C: int):
    import jax

    return _chunk_marks_jit(h, prev, w0, num_w, ws=ws, mins=mins, C=C)


def _make_chunk_jit():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("ws", "mins", "C"))
    def kernel(h, prev, w0, num_w, *, ws: int, mins: int, C: int):
        starts = jnp.minimum(
            jnp.int32(w0) + jnp.arange(C, dtype=jnp.int32), jnp.int32(num_w - 1)
        )
        idx = starts[:, None] + jnp.arange(ws, dtype=jnp.int32)[None, :]
        win = h[idx]
        srt = jnp.sort(win, axis=1)
        first = jnp.concatenate(
            [jnp.ones((C, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1
        )
        rank = jnp.cumsum(first.astype(jnp.int32), axis=1)
        kth = jnp.where(first & (rank == mins), srt, jnp.uint64(0))
        t = jnp.max(kth, axis=1)
        t = jnp.where(rank[:, -1] >= mins, t, jnp.uint64(_U64_MAX))
        qual = (win <= t[:, None]) & (prev[idx] < starts[:, None].astype(jnp.int64))
        return idx.reshape(-1), qual.reshape(-1)

    return kernel


class _LazyJit:
    _fn = None

    def __call__(self, *a, **k):
        if self._fn is None:
            self._fn = _make_chunk_jit()
        return self._fn(*a, **k)


_chunk_marks_jit = _LazyJit()

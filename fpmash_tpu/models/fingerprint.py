"""Fingerprint front-end: reads -> Lyndon-factorization fingerprints.

Batched device rebuild of the lyn2vec pipeline (lyn2vec/lyn2vec.py +
fingerprint_utils.py).  A *fingerprint* of a read is the sequence of factor
lengths of its Lyndon/inverse-Lyndon factorization; in "shift" mode every
cyclic 100-wide window of the read is fingerprinted separately
(fingerprint_utils.py:95-110), in "long" mode the read is split into
fixed-size chunks factorized independently and joined with ``|``
(fingerprint_utils.py:114-130, compute_long_fingerprint_by_list:480-518).

Where the reference forks a multiprocessing.Pool over read chunks
(lyn2vec.py:37-82), this implementation builds the whole shift batch as one
``[n_windows, width]`` u8 array and factorizes it on-device: the batched
Duval kernel (``fpmash_tpu.ops.lyndon``) for CFL, the ICFL automaton +
boundary-mask algebra (``ops/icfl.py`` + ``ops/factorize.py``) for every
other family, with the fused Triton kernel (``ops/fused_pallas.py``) for
CFL on the GPU.  The scalar models remain only as parity
oracles and for tiny inputs not worth a dispatch.

Output line formats are byte-compatible with the reference:
``ID len1 len2 ...`` for fingerprints and ``ID fac1 fac2 ...`` for factor
files, with ``<<``/``>>`` markers stripped before emission
(fingerprint_utils.py:461-470).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from fpmash_tpu.scalar.lyndon import FACTORIZATIONS, reverse_complement
from fpmash_tpu.utils.fasta import read_sequences

SHIFT_WINDOW = 100  # fingerprint_utils.py:456: shift_string(read, 100, shift)


def extract_reads(path: str, rev_com: bool = False) -> list[tuple[str, str]]:
    """Return ``(id, SEQUENCE)`` pairs for the *basic* pipeline.

    The line ID is the FASTA header's *second* token (the gene ID — the
    reference keeps ``s_list[1]``, fingerprint_utils.py:282-289), falling
    back to the first token when there is no second.  Sequences are
    uppercased (fingerprint_utils.py:365).

    ``rev_com=True`` reproduces the reference fixtures exactly: IDs gain a
    ``_0`` suffix and — because the reference appends reverse-complement
    lines under an inverted condition that never fires
    (fingerprint_utils.py:276-277,305-306) — *no* ``_1`` reverse-complement
    reads are emitted.  ``rev_com=False`` yields plain IDs (the reference's
    old, golden-producing behavior; its current code crashes on this path).
    """
    out = []
    for rec in read_sequences(path):
        rid = rec.comment.split()[0] if rec.comment else rec.name
        seq = rec.seq.upper()
        if rev_com:
            out.append((rid + "_0", seq))
        else:
            out.append((rid, seq))
    return out


def extract_long_reads(path: str, rev_com: bool = False) -> list[tuple[str, str]]:
    """Return ``(id, SEQUENCE)`` pairs for the *generalized* (long-read)
    pipeline.

    Unlike :func:`extract_reads`, the long-read reader keeps the header's
    *first* token and, with ``rev_com=True``, emits both the ``_0`` forward
    and ``_1`` reverse-complement lines (fingerprint_utils.py:165-201).
    """
    out = []
    for rec in read_sequences(path):
        rid = rec.name
        seq = rec.seq.upper()
        if rev_com:
            out.append((rid + "_0", seq))
            out.append((rid + "_1", reverse_complement(seq)))
        else:
            out.append((rid, seq))
    return out


def shift_windows(seq: str, size: int = SHIFT_WINDOW) -> list[str]:
    """All cyclic ``size``-wide windows of ``seq`` (fingerprint_utils.py:95).

    A sequence shorter than ``size`` yields itself unchanged; otherwise
    window ``i`` is ``seq[i:i+size]`` wrapping around the start.
    """
    n = len(seq)
    if n < size:
        return [seq]
    doubled = seq + seq[: size - 1]
    return [doubled[i : i + size] for i in range(n)]


def chunk_split(seq: str, size: int = 300) -> list[str]:
    """Split a long read into fixed-size chunks (fingerprint_utils.py:114)."""
    if len(seq) < size:
        return [seq]
    return [seq[i : i + size] for i in range(0, len(seq), size)]


def _strip_markers(factors: Sequence[str]) -> list[str]:
    return [f for f in factors if f not in ("<<", ">>")]


def fingerprint_reads(
    reads: Iterable[tuple[str, str]],
    factorization: str = "CFL",
    shift: bool = True,
    backend: str = "auto",
    with_factors: bool = False,
) -> tuple[list[str], list[str]]:
    """Basic pipeline: fingerprint each read (or each of its shift windows).

    Returns ``(fingerprint_lines, factor_lines)`` formatted exactly like
    ``compute_fingerprint_by_list`` (fingerprint_utils.py:443-476): one line
    per window, ``ID len1 len2 ...``; ``factor_lines`` is empty unless
    ``with_factors``.

    ``backend='jax'`` routes CFL-family factorizations through the batched
    device kernel; ``'scalar'`` forces the pure-Python models; ``'auto'``
    picks the device kernel when available for the factorization type.
    """
    reads = list(reads)
    ids: list[str] = []
    windows: list[str] = []
    for rid, seq in reads:
        for w in shift_windows(seq) if shift else [seq]:
            ids.append(rid)
            windows.append(w)

    factor_lists = factorize_batch(windows, factorization, backend)

    fingerprint_lines = []
    factor_lines = []
    for rid, factors in zip(ids, factor_lists):
        factors = _strip_markers(factors)
        fingerprint_lines.append(rid + " " + " ".join(str(len(f)) for f in factors) + "\n")
        if with_factors:
            factor_lines.append(rid + " " + " ".join(factors) + "\n")
    return fingerprint_lines, factor_lines


def fingerprint_long_reads(
    reads: Iterable[tuple[str, str]],
    factorization: str = "CFL",
    split: int = 300,
    backend: str = "auto",
    with_factors: bool = False,
) -> tuple[list[str], list[str]]:
    """Generalized pipeline: one line per read, chunk fingerprints joined
    with `` | `` (compute_long_fingerprint_by_list, :480-518).

    Preserves the reference's trailing separator: every line ends with
    ``... | `` before the newline.
    """
    reads = list(reads)
    ids: list[str] = []
    chunks: list[str] = []
    bounds: list[int] = [0]
    for rid, seq in reads:
        cs = chunk_split(seq, split)
        ids.append(rid)
        chunks.extend(cs)
        bounds.append(bounds[-1] + len(cs))

    factor_lists = factorize_batch(chunks, factorization, backend)

    fingerprint_lines = []
    factor_lines = []
    for r, rid in enumerate(ids):
        fp_segments = []
        fac_segments = []
        for factors in factor_lists[bounds[r] : bounds[r + 1]]:
            factors = _strip_markers(factors)
            fp_segments.append(" ".join(str(len(f)) for f in factors))
            fac_segments.append(" ".join(factors))
        # note the double space after the ID: the reference concatenates
        # "ID " + " " before the first segment (fingerprint_utils.py:494-495)
        fingerprint_lines.append(rid + "  " + " | ".join(fp_segments) + " | \n")
        if with_factors:
            factor_lines.append(rid + "  " + " | ".join(fac_segments) + " | \n")
    return fingerprint_lines, factor_lines


def factorize_batch(
    windows: Sequence[str], factorization: str, backend: str = "auto"
) -> list[list[str]]:
    """Factorize a batch of strings, dispatching to the device kernel when
    possible.

    Every factorization family has a batched device kernel (the Duval and
    ICFL automatons composed through boundary-mask algebra,
    :mod:`fpmash_tpu.ops.factorize`); ``auto`` uses it for batches large
    enough to amortize dispatch, the native C factorizer otherwise.
    """
    if factorization not in FACTORIZATIONS:
        raise ValueError(
            f"unknown factorization {factorization!r}; "
            f"expected one of {sorted(FACTORIZATIONS)}"
        )
    max_len = max((len(w) for w in windows), default=0)
    # non-CFL kernels pack positions into 10-bit level records
    device_ok = factorization == "CFL" or max_len <= 1023
    if backend == "auto":
        if device_ok and len(windows) >= 64:
            backend = "jax"
        else:
            backend = "native"
    if backend == "jax" and factorization == "CFL":
        from fpmash_tpu.ops.lyndon import cfl_factor_strings

        return cfl_factor_strings(windows)
    if backend == "jax" and device_ok:
        from fpmash_tpu.ops.factorize import factorize_windows_device

        lens = factorize_windows_device(list(windows), factorization)
        return [_slice_factors(w, ls) for w, ls in zip(windows, lens)]
    if backend == "jax":
        backend = "native"  # rows too wide for the device family kernels
    if backend == "native":
        from fpmash_tpu.utils.native_lyndon import factorize_batch_native

        lens = factorize_batch_native(list(windows), factorization)
        if lens is not None:
            return [_slice_factors(w, ls) for w, ls in zip(windows, lens)]
    fn = FACTORIZATIONS[factorization]
    return [fn(w) for w in windows]


def _slice_factors(w: str, lens: Sequence[int]) -> list[str]:
    out = []
    pos = 0
    for n in lens:
        out.append(w[pos : pos + n])
        pos += n
    return out


def run_basic(
    fasta_path: str,
    out_dir: str,
    factorization: str = "CFL",
    rev_com: bool = False,
    shift: bool = True,
    with_factors: bool = True,
    backend: str = "auto",
) -> tuple[str, str | None]:
    """End-to-end basic pipeline: FASTA -> fingerprint_<FACT>.txt
    (+ fact_fingerprint_<FACT>.txt), mirroring ``basic_fingerprint``
    (lyn2vec.py:14-93).  Returns the paths written.
    """
    import os

    reads = extract_reads(fasta_path, rev_com)
    if not reads:
        raise ValueError(f"no reads extracted from {fasta_path}")
    fp_lines, fac_lines = fingerprint_reads(
        reads, factorization, shift=shift, backend=backend, with_factors=with_factors
    )
    fp_path = os.path.join(out_dir, f"fingerprint_{factorization}.txt")
    with open(fp_path, "w") as fh:
        fh.writelines(fp_lines)
    fac_path = None
    if with_factors:
        fac_path = os.path.join(out_dir, f"fact_fingerprint_{factorization}.txt")
        with open(fac_path, "w") as fh:
            fh.writelines(fac_lines)
    return fp_path, fac_path

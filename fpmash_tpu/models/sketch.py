"""Sketch engine: the central MinHash container and its construction paths.

Batched device rebuild of ``mash/src/mash/Sketch.{h,cpp}``.  The reference's OO
container (vector<Reference> + robin_hood indexes + pthread pool) becomes a
thin host-side list of references whose hash arrays are produced by batched
device kernels:

* fingerprint path (``init from fingerprints``, Sketch.cpp:56-151): every
  fingerprint line = one MurmurHash3 of its uint64 length-vector, kept in
  file order, unsorted, no bottom-k — all lines of all files are hashed in
  ONE device batch (ops.murmur3.murmur3_u64_batch).
* classic path (``sketchSequence``/``sketchFile``, Sketch.cpp:1299-1526):
  k-mer scan + canonicalization + hash (ops.kmers) + bottom-k distinct
  selection (ops.bottomk), per reference or concatenated per input set.

Persistence is byte-compatible ``.msh`` via utils.msh; parameter
compatibility checks and the 32/64-bit hash rule follow the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np

from fpmash_tpu.utils.trace import trace

#: global fingerprint line cap across all files (Sketch.cpp:37,82)
LIMIT_READ_FINGERPRINT = 1_000_000

#: chunk size (bases) for the fused direct classic sketch route
#: (tests shrink it to exercise the multi-chunk merge)
_DIRECT_CHUNK = 1 << 24


@dataclass
class SketchParams:
    """Sketch::Parameters (Sketch.h:81-120) with the same defaults
    (Command.cpp:183-228): k=21, s=1000, seed=42, canonical DNA."""

    kmer_size: int = 21
    sketch_size: int = 1000  # minHashesPerWindow
    seed: int = 42
    noncanonical: bool = False
    preserve_case: bool = False
    alphabet: str = "ACGT"
    concatenated: bool = True
    error: float = 0.0
    window_size: int = 0
    reads: bool = False
    min_cov: int = 1
    target_cov: float = 0.0
    #: -b memory bound in bytes; >0 switches reads-mode admission to the
    #: approximate Bloom filter (MinHashHeap.cpp:19-41), bounding memory
    #: instead of counting exactly
    bloom_bytes: int = 0
    counts: bool = False
    fingerprint: bool = False
    windowed: bool = False

    @property
    def use64(self) -> bool:
        """64-bit hashes iff alphabet^k exceeds 2^32 (Sketch.cpp:1288)."""
        return len(self.alphabet) ** self.kmer_size > 2**32

    @property
    def kmer_space(self) -> float:
        """alphabetSize^kmerSize (Sketch.cpp:660)."""
        return float(len(self.alphabet)) ** self.kmer_size

    def for_fingerprint(self) -> "SketchParams":
        """Fingerprint-mode overrides (sketchParameterSetup.cpp:78-84):
        k=1, noncanonical, alphabet '0123456789' (=> 32-bit hashes)."""
        return replace(
            self, kmer_size=1, noncanonical=True, alphabet="0123456789", fingerprint=True
        )


@dataclass
class Reference:
    """One sketched reference (Sketch.h:177-186)."""

    name: str = ""
    comment: str = ""
    length: int = 0
    hashes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    counts: np.ndarray | None = None
    counts_sorted: bool = False


class Sketch:
    """Container of sketched references + parameters."""

    def __init__(self, params: SketchParams | None = None):
        self.params = params or SketchParams()
        self.references: list[Reference] = []
        self._index_by_id: dict[str, int] = {}
        #: windowed-mode loci: (reference index, position, hash64)
        self.loci: list[tuple[int, int, int]] = []
        self._loci_by_hash: dict[int, list[tuple[int, int]]] = {}

    # ------------------------------------------------------------------ #
    # fingerprint path
    # ------------------------------------------------------------------ #

    def init_from_fingerprints(
        self, files: list[str], bug_compat_length: bool = True, backend: str = "auto"
    ) -> None:
        """Load fingerprint ``.txt`` files (Sketch.cpp:56-151).

        Line format ``ID n1 n2 ...``; consecutive lines with equal ID are
        grouped into one reference (Sketch.cpp:103-129 — non-adjacent
        duplicate IDs create separate references); each line becomes one
        hash of its uint64 vector, appended in file order (unsorted, no
        bottom-k).  A global cap of 1e6 lines applies across all files.

        ``bug_compat_length=True`` reproduces the reference's length
        accounting where the first line of each reference is counted twice
        (length is initialized to the first line's size and then
        incremented for every line including the first, Sketch.cpp:117,134).
        """
        p = self.params
        line_budget = LIMIT_READ_FINGERPRINT

        groups: list[tuple[str, list[list[int]]]] = []
        last_id = None  # NOTE: carries across files, like the reference
        for path in files:
            with open(path) as fh:
                for line in fh:
                    if line_budget <= 0:
                        break
                    line_budget -= 1
                    parts = line.split()
                    if not parts:
                        continue
                    rid = parts[0]
                    # mirror `ss >> uint64_t`: stop at first non-integer token
                    vec = []
                    for tok in parts[1:]:
                        try:
                            vec.append(int(tok))
                        except ValueError:
                            break
                    if rid != last_id:
                        groups.append((rid, []))
                        last_id = rid
                    groups[-1][1].append(vec)

        # hash all lines in one device batch
        all_vecs = [v for _, vecs in groups for v in vecs]
        with trace("fingerprint-hash", lines=len(all_vecs)):
            hashes = _hash_u64_vectors(all_vecs, p.seed, p.use64, backend)

        pos = 0
        for rid, vecs in groups:
            n = len(vecs)
            sizes = [len(v) for v in vecs]
            length = sum(sizes)
            if bug_compat_length and sizes:
                length += sizes[0]
            self.references.append(
                Reference(
                    name=rid,
                    comment=f"FingerPrint : {rid}",
                    length=length,
                    hashes=hashes[pos : pos + n],
                )
            )
            pos += n
        self._create_index()

    def init_from_reads_fingerprint(
        self,
        reads,
        factorization: str = "CFL",
        shift: bool = True,
        bug_compat_length: bool = True,
    ) -> None:
        """Integrated device path: reads -> shift windows -> factorize ->
        hash -> references, without materializing fingerprint text.

        Produces exactly the same sketches as running the lyn2vec pipeline
        to a ``.txt`` and then :meth:`init_from_fingerprints` on it
        (asserted in tests), but the windows, Duval factorization and
        MurmurHash3 all stay on device.  ``reads`` yields ``(id, SEQ)``.
        """
        import jax.numpy as jnp

        from fpmash_tpu.models.fingerprint import SHIFT_WINDOW, shift_windows
        from fpmash_tpu.ops.lyndon import cfl_lengths_onehot
        from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

        p = self.params
        reads = list(reads)
        # every factorization family now has a device kernel
        # (ops/factorize.py); the host factorizer remains only for tiny
        # inputs (not worth a dispatch) and rows wider than the ICFL
        # kernel's 10-bit position packing
        n_windows_est = sum(
            max(1, len(s)) if shift and len(s) >= 100 else 1 for _, s in reads
        )
        max_read = max((len(s) for _, s in reads), default=0)
        host_route = factorization != "CFL" and (
            n_windows_est < 256 or (not shift and max_read > 1023)
        )
        if host_route:
            # non-CFL families route through the native/scalar factorizer
            from fpmash_tpu.models.fingerprint import factorize_batch

            groups = []
            for rid, seq in reads:
                windows = shift_windows(seq) if shift else [seq]
                factors = factorize_batch(windows, factorization, "auto")
                vecs = [[len(f) for f in fl if f not in ("<<", ">>")] for fl in factors]
                groups.append((rid, vecs))
            line_budget = LIMIT_READ_FINGERPRINT
            all_vecs = []
            trimmed = []
            for rid, vecs in groups:
                take = vecs[: max(0, line_budget)]
                line_budget -= len(take)
                if take:
                    trimmed.append((rid, take))
                    all_vecs.extend(take)
            hashes = _hash_u64_vectors(all_vecs, p.seed, p.use64, "auto")
            pos = 0
            for rid, vecs in trimmed:
                sizes = [len(v) for v in vecs]
                length = sum(sizes) + (sizes[0] if bug_compat_length and sizes else 0)
                self.references.append(
                    Reference(
                        name=rid,
                        comment=f"FingerPrint : {rid}",
                        length=length,
                        hashes=hashes[pos : pos + len(vecs)],
                    )
                )
                pos += len(vecs)
            self._create_index()
            return

        # device path: every read is uploaded ONCE as a flat byte stream
        # (extended by its first W-1 bytes in shift mode, so each cyclic
        # window is contiguous); window b is
        # stream[starts[b] : starts[b] + lengths[b]] — shift windows
        # overlap ~W x, so no [windows, W] byte matrix is built on the host
        W = SHIFT_WINDOW
        ids, counts, segs, st_parts, len_parts = [], [], [], [], []
        budget = LIMIT_READ_FINGERPRINT
        off = 0
        Lmax = 1
        for rid, seq in reads:
            ids.append(rid)
            take = 0
            if budget > 0:
                b = seq.upper().encode("ascii", "replace")
                n = len(b)
                wide = shift and n >= W
                take = min(n if wide else 1, budget)
                budget -= take
                segs.append(b + b[: W - 1] if wide else b)
                st_parts.append(off + np.arange(take, dtype=np.int64))
                len_parts.append(np.full(take, W if wide else n, np.int32))
                Lmax = max(Lmax, W if wide else n)
                off += len(segs[-1])
            counts.append(take)
        if off + Lmax >= 1 << 31:
            raise ValueError("fingerprint input too large for one device batch")
        row_ptr = sum(counts)
        stream = np.zeros(_round_up_pow2(off + Lmax, 4096), np.uint8)
        stream[:off] = np.frombuffer(b"".join(segs), np.uint8)
        B = _round_up_pow2(row_ptr, 1024)
        starts = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        if row_ptr:
            starts[:row_ptr] = np.concatenate(st_parts)
            lengths[:row_ptr] = np.concatenate(len_parts)

        with trace("factorize+hash", windows=row_ptr):
            # every dispatch below goes through shard_rows: with >1 visible
            # device the window rows data-parallelize over a 1-D dp mesh
            # (row-independent -> bitwise-identical results) and the
            # stream is replicated; with one device it is a plain call
            from fpmash_tpu import route
            from fpmash_tpu.ops import fused_pallas
            from fpmash_tpu.ops.lyndon import windows_from_stream
            from fpmash_tpu.parallel.sharded import shard_rows

            ok = None
            if factorization == "CFL" and (
                route.cfl_kernel() == "triton" and Lmax <= fused_pallas.MAX_L
            ):
                # fused Triton kernel: Duval + murmur per lane, factor
                # lengths never leave registers (ops/fused_pallas.py)
                h1, fac_count = shard_rows(
                    lambda s, l, x: fused_pallas.fingerprint_hashes_stream(
                        x, s, l, L=Lmax, seed=p.seed
                    ),
                    (starts, lengths),
                    replicated=(stream,),
                )
            elif factorization == "CFL":

                def _split_cfl(s, l, x):
                    fac_len, fac_count = cfl_lengths_onehot(
                        windows_from_stream(x, s, l, L=Lmax), l
                    )
                    h1, _ = murmur3_u64_batch(
                        fac_len.astype(jnp.uint64), fac_count, seed=p.seed
                    )
                    return h1, fac_count

                h1, fac_count = shard_rows(
                    _split_cfl, (starts, lengths), replicated=(stream,)
                )
            else:
                # family-composed boundary kernels (ICFL automaton + mask
                # algebra; ops/factorize.py) + murmur pipeline
                from fpmash_tpu.ops.factorize import factor_lengths_device

                uniform = bool(((lengths == Lmax) | (lengths == 0)).all())

                def _split_family(s, l, x):
                    fac_len, fac_count, ok = factor_lengths_device(
                        windows_from_stream(x, s, l, L=Lmax), l,
                        factorization, uniform,
                    )
                    h1, _ = murmur3_u64_batch(
                        fac_len.astype(jnp.uint64), fac_count, seed=p.seed
                    )
                    return h1, fac_count, ok

                h1, fac_count, ok = shard_rows(
                    _split_family, (starts, lengths), replicated=(stream,)
                )
            if ok is not None:
                ok = np.asarray(ok)[:row_ptr]
            if ok is not None and not ok.all():  # pragma: no cover - >64 ICFL levels/row
                h1 = np.asarray(h1).copy()
                fac_count = np.asarray(fac_count).copy()
                from fpmash_tpu.scalar.lyndon import FACTORIZATIONS

                fn = FACTORIZATIONS[factorization]
                for b in np.nonzero(~ok)[0]:
                    w = stream[starts[b] : starts[b] + lengths[b]]
                    vec = [len(f) for f in fn(w.tobytes().decode("latin-1"))
                           if f not in ("<<", ">>")]
                    h1[b] = _hash_u64_vectors([vec], p.seed, True, "scalar")[0]
                    fac_count[b] = len(vec)
        h1 = np.asarray(h1)[:row_ptr]
        if not p.use64:
            h1 = h1 & np.uint64(0xFFFFFFFF)
        fac_count_np = np.asarray(fac_count)[:row_ptr]

        pos = 0
        for rid, cnt in zip(ids, counts):
            if cnt == 0:
                continue
            sizes = fac_count_np[pos : pos + cnt]
            length = int(np.sum(sizes)) + (int(sizes[0]) if bug_compat_length and len(sizes) else 0)
            self.references.append(
                Reference(
                    name=rid,
                    comment=f"FingerPrint : {rid}",
                    length=length,
                    hashes=h1[pos : pos + cnt],
                )
            )
            pos += cnt
        self._create_index()

    # ------------------------------------------------------------------ #
    # classic sequence path
    # ------------------------------------------------------------------ #

    def init_from_sequences(
        self,
        records,
        name: str = "",
        comment: str = "",
        merge: bool = False,
        backend: str = "auto",
    ) -> None:
        """Sketch sequence records (classic k-mer MinHash path).

        ``records`` yields ``(name, comment, seq)``.  With ``merge=True``
        all records feed one reference (concatenated / reads mode,
        Sketch::initFromReads); otherwise one reference per record
        (``-i`` individual / per-sequence mode, sketchFileBySequence).
        """
        p = self.params
        if p.windowed:
            # windowed ("minmer") mode (sketchSequence, Sketch.cpp:1504-1507):
            # one reference per record, loci instead of a bottom-k hash list.
            # COMMAND_FIND builds force concatenated=false
            # (sketchParameterSetup.cpp:20-24), so merge never applies.
            from fpmash_tpu.ops.winnow import minmer_positions

            for rname, rcomment, seq in records:
                if len(seq) < p.kmer_size:
                    continue
                ref_idx = len(self.references)
                ph = _position_hashes(seq, p, backend)
                ws = min(p.window_size, len(ph))  # clamp (Sketch.cpp:748-751)
                positions, phashes = minmer_positions(
                    ph, ws, p.sketch_size, backend=backend
                )
                self.references.append(
                    Reference(
                        name=name or rname,
                        comment=comment or rcomment,
                        length=len(seq),
                    )
                )
                self.loci.extend(
                    (ref_idx, int(pos), int(h))
                    for pos, h in zip(positions, phashes)
                )
            self._create_index()
            return
        if merge:
            records = list(records)
            pools = []
            total_len = 0
            count = 0
            first_name = first_comment = ""
            for rname, rcomment, seq in records:
                if len(seq) < p.kmer_size:
                    continue
                if count == 0:
                    first_name, first_comment = rname, rcomment
                count += 1
                total_len += len(seq)
                pools.append(seq)
            if p.reads and p.target_cov > 0:
                # adaptive stop at target coverage (sketchFile,
                # Sketch.cpp:1410-1414): hash reads in chunks, re-estimate
                # mean multiplicity of the kept sketch after each chunk,
                # and stop consuming input once it reaches target_cov.
                from fpmash_tpu.ops.bottomk import estimate_multiplicity

                hashes = np.zeros(0, np.uint64)
                values = np.zeros(0, np.uint64)
                counts = np.zeros(0, np.uint32)
                used = 0
                CHUNK_READS = 256
                while used < len(pools):
                    chunk = pools[used : used + CHUNK_READS]
                    used += len(chunk)
                    hashes = np.concatenate(
                        [hashes, _kmer_hash_pool(chunk, p, backend)]
                    )
                    values, counts = _bottom_k(hashes, p, backend)
                    if (
                        len(values) >= p.sketch_size
                        and estimate_multiplicity(counts) >= p.target_cov
                    ):
                        break
                count = used
            else:
                direct = _classic_sketch_direct(pools, p, backend)
                if direct is not None:
                    with trace("classic-direct", bases=total_len):
                        values, counts = direct
                else:
                    with trace("kmer-hash", bases=total_len):
                        hashes = _kmer_hash_pool(pools, p, backend)
                    with trace("bottom-k", pool=len(hashes)):
                        values, counts = _bottom_k(hashes, p, backend)
            if p.reads:
                # reads mode stores the cardinality estimate as "length"
                # (sketchFile, Sketch.cpp:1425-1436): genome size if given,
                # else estimateSetSize from the top kept hash.
                from fpmash_tpu.ops.bottomk import estimate_set_size

                bits = 64 if p.use64 else 32
                total_len = int(estimate_set_size(values, p.sketch_size, bits))
            # comment = first record's "name comment"; multi-record inputs
            # get the "[N seqs] ... [...]" wrapper (Sketch.cpp:1438-1446)
            rcomment = comment
            if not rcomment:
                rcomment = (first_name + " " + first_comment).rstrip()
                if first_comment:
                    rcomment = first_name + " " + first_comment
                if count > 1:
                    rcomment = f"[{count} seqs] {rcomment} [...]"
            self.references.append(
                Reference(
                    name=name or first_name,
                    comment=rcomment,
                    length=total_len,
                    hashes=values,
                    counts=counts if p.counts else None,
                    counts_sorted=p.counts,
                )
            )
        else:
            for rname, rcomment, seq in records:
                if len(seq) < p.kmer_size:
                    continue
                direct = _classic_sketch_direct([seq], p, backend)
                if direct is not None:
                    values, counts = direct
                else:
                    hashes = _kmer_hash_pool([seq], p, backend)
                    values, counts = _bottom_k(hashes, p, backend)
                self.references.append(
                    Reference(
                        name=name or rname,
                        comment=comment or rcomment,
                        length=len(seq),
                        hashes=values,
                        counts=counts if p.counts else None,
                        counts_sorted=p.counts,
                    )
                )
        self._create_index()

    def init_from_files(
        self,
        files: list[str],
        individual: bool = False,
        backend: str = "auto",
    ) -> None:
        """Sketch FASTA/FASTQ files (Sketch::initFromFiles semantics).

        Default (concatenated per file): one reference per file named after
        the file, comment from the first record (sketchFile,
        Sketch.cpp:1299-1488).  ``individual=True``: one reference per
        sequence.  ``.msh`` inputs load via the capnp codec with the
        load-time truncation rule.
        """
        from fpmash_tpu.utils.fasta import read_sequences

        for path in files:
            # suffix selects sketch inputs; .msw in windowed mode
            # (Sketch.cpp:257)
            if path.endswith(".msw" if self.params.windowed else ".msh"):
                self.load_msh(path)
                continue
            records = list(read_sequences(path))
            if individual or self.params.windowed:
                self.init_from_sequences(records, backend=backend)
            else:
                # concatenated: reference named after the file path as given
                # (sketchFile sets reference.name = fileNames[f])
                self.init_from_sequences(records, name=path, merge=True, backend=backend)
        self._create_index()

    def init_from_reads(
        self, files: list[str], name: str = "", comment: str = "", backend: str = "auto"
    ) -> None:
        """Reads mode: all records of all files merge into ONE reference
        (Sketch::initFromReads, Sketch.cpp:203-247); requires counts."""
        from fpmash_tpu.utils.fasta import read_sequences

        records = []
        for path in files:
            records.extend(read_sequences(path))
        self.init_from_sequences(
            records,
            name=name or (files[0] if files else ""),
            comment=comment,
            merge=True,
            backend=backend,
        )

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    def load_msh(self, path: str, truncate: bool = True) -> None:
        """Load a ``.msh``; adopt its parameters; truncate each hash list
        to the active sketch_size like loadCapnp (Sketch.cpp:1117-1120)."""
        from fpmash_tpu.utils.msh import read_msh

        m = read_msh(path)
        self.params = replace(
            self.params,
            kmer_size=m.kmer_size,
            sketch_size=m.min_hashes_per_window,
            seed=m.hash_seed,
            noncanonical=m.noncanonical,
            preserve_case=m.preserve_case,
            alphabet=m.alphabet,
            concatenated=m.concatenated,
            error=m.error,
            window_size=m.window_size,
            windowed=bool(m.loci) or m.window_size > 0,
        )
        base = len(self.references)
        self.loci.extend((base + int(s), int(pos), int(h)) for s, pos, h in m.loci)
        cap = self.params.sketch_size
        for r in m.references:
            if self.params.use64:
                hashes = r.hashes64 if r.hashes64 is not None else np.zeros(0, np.uint64)
            else:
                hashes = r.hashes32 if r.hashes32 is not None else np.zeros(0, np.uint32)
            hashes = np.asarray(hashes, np.uint64)
            if truncate and len(hashes) > cap:
                hashes = hashes[:cap]
            counts = None
            if r.counts32 is not None:
                counts = np.asarray(r.counts32, np.uint32)[: len(hashes)]
            self.references.append(
                Reference(
                    name=r.name,
                    comment=r.comment,
                    length=r.length,
                    hashes=hashes,
                    counts=counts,
                    counts_sorted=r.counts32_sorted,
                )
            )
        self._create_index()

    def write_msh(self, path: str) -> None:
        from fpmash_tpu.utils.msh import MshFile, MshReference, write_msh

        p = self.params
        m = MshFile(
            kmer_size=p.kmer_size,
            window_size=p.window_size,
            min_hashes_per_window=p.sketch_size,
            concatenated=p.concatenated,
            error=p.error,
            noncanonical=p.noncanonical,
            alphabet=p.alphabet,
            preserve_case=p.preserve_case,
            hash_seed=p.seed,
        )
        for r in self.references:
            mr = MshReference(
                name=r.name,
                comment=r.comment,
                length=int(r.length),
                counts32_sorted=bool(r.counts_sorted and r.counts is not None and p.counts),
            )
            if p.use64:
                mr.hashes64 = np.asarray(r.hashes, np.uint64)
            else:
                mr.hashes32 = np.asarray(r.hashes, np.uint64).astype(np.uint32)
            if r.counts is not None and p.counts:
                mr.counts32 = np.asarray(r.counts, np.uint32)
            m.references.append(mr)
        m.loci = list(self.loci)
        write_msh(path, m)

    # ------------------------------------------------------------------ #

    def _create_index(self) -> None:
        self._index_by_id = {r.name: i for i, r in enumerate(self.references)}
        # hash -> [(reference index, position)] (createIndex, Sketch.cpp:644-662)
        self._loci_by_hash = {}
        for seq_idx, pos, h in self.loci:
            self._loci_by_hash.setdefault(h, []).append((seq_idx, pos))

    def loci_by_hash(self, h: int) -> list[tuple[int, int]]:
        return self._loci_by_hash.get(int(h), [])

    def reference_index(self, name: str) -> int:
        """Index of reference ``name``, or -1 (Sketch.cpp:189-200)."""
        return self._index_by_id.get(name, -1)

    def __len__(self) -> int:
        return len(self.references)

    def check_compatible(self, other: "Sketch") -> list[str]:
        """Parameter compatibility warnings (Sketch.cpp:277-309 /
        CommandDistance.cpp:146-155 semantics)."""
        issues = []
        a, b = self.params, other.params
        if a.kmer_size != b.kmer_size:
            issues.append(f"kmer size mismatch ({a.kmer_size} vs {b.kmer_size})")
        if a.alphabet != b.alphabet:
            issues.append("alphabet mismatch")
        if a.noncanonical != b.noncanonical:
            issues.append("canonicality mismatch")
        if a.seed != b.seed:
            issues.append(f"seed mismatch ({a.seed} vs {b.seed})")
        if a.preserve_case != b.preserve_case:
            issues.append("case handling mismatch")
        return issues


# ---------------------------------------------------------------------- #
# kernels dispatch
# ---------------------------------------------------------------------- #


def _hash_u64_vectors(vecs, seed: int, use64: bool, backend: str) -> np.ndarray:
    """Hash a list of u64 vectors; returns u64 array (low 32 bits if !use64)."""
    if not vecs:
        return np.zeros(0, np.uint64)
    if backend == "scalar" or (backend == "auto" and len(vecs) < 64):
        from fpmash_tpu.scalar.murmur3 import hash_u64_vector

        return np.array(
            [hash_u64_vector(v, seed=seed, use64=use64) for v in vecs], np.uint64
        )

    import jax.numpy as jnp

    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    n = len(vecs)
    L = max((len(v) for v in vecs), default=1)
    # bucket both dims to powers of two so repeated calls reuse compiles
    B = _round_up_pow2(n, 64)
    L = _round_up_pow2(max(L, 1), 16)
    arr = np.zeros((B, L), np.uint64)
    cnt = np.zeros(B, np.int32)
    for i, v in enumerate(vecs):
        arr[i, : len(v)] = v
        cnt[i] = len(v)
    h1, _ = murmur3_u64_batch(jnp.asarray(arr), jnp.asarray(cnt), seed=seed)
    h1 = np.asarray(h1)[:n]
    return h1 if use64 else (h1 & np.uint64(0xFFFFFFFF))


def _round_up_pow2(n: int, floor: int = 1024) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


def _classic_sketch_direct(seqs: list[str], p: SketchParams, backend: str):
    """Fused on-device classic sketch: sequences -> bottom-k in one
    dispatch per chunk, only ``s``-sized results ever leaving the device.

    The pool path (:func:`_kmer_hash_pool` + :func:`_bottom_k`) downloads
    the ENTIRE hash pool to the host and re-uploads it — 16 B/base of
    PCIe traffic that dwarfs compute at genome scale.  This route runs
    :func:`fpmash_tpu.ops.kmers.classic_sketch_device` on 16-Mbase chunks
    and merges the per-chunk bottom-k host-side.

    The merge is EXACT: if value v is in the global bottom-s distinct
    set, then in every chunk where v occurs the chunk-local distinct
    values below v are a subset of the global ones (< s of them), so v
    is in that chunk's bottom-s with its full local count — values union
    and counts sum.  ``min_cov`` filtering therefore applies only AFTER
    the merge (chunks must not pre-filter); multi-chunk inputs with
    min_cov > 1 could still under-collect per chunk (count-1 values
    crowd the chunk's s slots), so they fall back to the pool path.

    Returns ``(values, counts)`` or ``None`` when ineligible (scalar
    backend, non-ACGT alphabet, k outside (16, 32], input below the
    chunk/8 gate, Bloom admission, or a reads-mode threshold that stays
    under-collected at max boost).
    """
    import jax

    if not seqs:
        return None
    if backend == "scalar":
        return None
    if set(p.alphabet) != set("ACGT") or not (16 < p.kmer_size <= 32):
        return None
    if not p.use64:  # 4^k > 2^32 holds for k > 16, but stay explicit
        return None
    from fpmash_tpu.parallel.sharded import visible_device_count

    n_dev = visible_device_count()

    from fpmash_tpu.ops.kmers import classic_sketch_device

    k = p.kmer_size
    sep = b"\x00" * (k - 1)
    blob = sep.join(
        s.encode("ascii", "replace") if isinstance(s, str) else bytes(s)
        for s in seqs
    )
    n = len(blob)
    # below CHUNK/8 valid bases the fused route's N-based threshold
    # cannot guarantee s candidates within its boost ladder (see
    # classic_sketch_device), and the pool path's transfer is modest
    if n < max(4096, _DIRECT_CHUNK >> 3):
        return None
    # one fixed chunk shape, so the route compiles one program
    size = _DIRECT_CHUNK
    step = size - (k - 1)
    starts = list(range(0, n, step))
    if p.bloom_bytes > 0 and p.reads:
        # Bloom admission is an order-dependent streaming approximation
        # (-b, MinHashHeap.cpp:78-95); only the pool path reproduces it
        return None
    if p.min_cov > 1:
        # reads-mode exact route: chunks return ALL sub-threshold
        # survivors with counts (collect-all contract), min_cov applies
        # after the cross-chunk merge
        return _direct_reads_sketch(blob, starts, size, step, n, p)
    need_counts = bool(p.counts or p.min_cov > 1 or p.target_cov > 0)

    # chunks are data-independent until the host merge, so they
    # round-robin across visible devices (multi-device DP: each device
    # runs its chunks, only s-sized results return).  TWO-PHASE dispatch:
    # all chunks go in flight at boost 1 WITHOUT a blocking fetch between
    # them (a per-chunk `bool(ok)` sync would serialize the chunks and
    # defeat the round-robin); then results drain in order and
    # under-collected chunks retry as a second batched boost-2 wave on
    # their device-resident buffers.
    devices = jax.devices()[:n_dev]
    vals_all = []
    counts_all = []
    # tail slivers shorter than k have zero possible windows: skip them
    # outright instead of letting an unfillable chunk sink the route
    starts = [pos for pos in starts if min(pos + size, n) - pos >= k]

    def dispatch(ci, pos, boost, bufs=None):
        if bufs is None:
            end = min(pos + size, n)
            buf = np.zeros(size, np.uint8)
            buf[: end - pos] = np.frombuffer(blob[pos:end], np.uint8)
            # windows starting in the k-1 overlap belong to the next chunk
            length = (end - pos) if end == n else (step + k - 1)
            dev = devices[ci % len(devices)]
            buf_d = jax.device_put(buf, dev)
            len_d = jax.device_put(np.int32(length), dev)
        else:
            buf_d, len_d = bufs
        out = classic_sketch_device(
            buf_d,
            len_d,
            k=k,
            s=p.sketch_size,
            noncanonical=p.noncanonical,
            preserve_case=p.preserve_case,
            seed=p.seed,
            min_cov=1,
            boost=boost,
            need_counts=need_counts,
        )
        return (buf_d, len_d), out

    wave1 = [dispatch(ci, pos, 1) for ci, pos in enumerate(starts)]
    results: dict[int, tuple] = {}
    retry = []
    for ci, (bufs, out) in enumerate(wave1):
        values, counts, nv, ok = out
        if bool(ok):  # drains in order; later chunks keep executing
            results[ci] = (np.asarray(values), np.asarray(counts), int(nv))
        else:
            retry.append((ci, bufs))
    wave2 = [(ci, dispatch(ci, None, 2, bufs)[1]) for ci, bufs in retry]
    for ci, out in wave2:
        values, counts, nv, ok = out
        if bool(ok):
            results[ci] = (np.asarray(values), np.asarray(counts), int(nv))
        else:
            # boost ladder exhausted (pathological distribution /
            # mostly-invalid chunk): exact pool pass over JUST this
            # chunk instead of abandoning the whole route
            results[ci] = _chunk_pool_bottom_k(
                blob, starts[ci], size, n, p, need_counts
            )
    for ci in range(len(starts)):
        v, c, nv = results[ci]
        vals_all.append(v[:nv])
        counts_all.append(c[:nv])

    v = np.concatenate(vals_all)
    c = np.concatenate(counts_all).astype(np.uint64)
    if len(v) == 0:
        # saturated-empty chunks (e.g. an all-N sequence) return ok with
        # zero candidates
        return v, c.astype(np.uint32)
    order = np.argsort(v, kind="stable")
    v, c = v[order], c[order]
    is_start = np.concatenate([[True], v[1:] != v[:-1]])
    grp = np.cumsum(is_start) - 1
    csum = np.zeros(int(grp[-1]) + 1 if len(grp) else 0, np.uint64)
    np.add.at(csum, grp, c)
    vals = v[is_start]
    if not need_counts:
        # per-chunk counts were 1-filled (nothing consumes them); keep
        # the same contract after the merge instead of chunk-presence
        # tallies
        csum = np.ones_like(csum)
    keep = csum >= p.min_cov
    vals, csum = vals[keep], csum[keep]
    return vals[: p.sketch_size], csum[: p.sketch_size].astype(np.uint32)


def _direct_reads_sketch(blob, starts, size, step, n, p: SketchParams):
    """Reads-mode (min_cov > 1) fused direct route.

    The reference streams reads through MinHashHeap with count-gated
    admission (Sketch.cpp:1299-1488, MinHashHeap.cpp:78-95).  Distributive
    reformulation: every chunk returns ALL its
    distinct sub-threshold hashes with exact counts (collect-all
    contract, threshold shared across chunks since it is sized by the
    static chunk shape), counts sum across chunks, min_cov filters AFTER
    the merge, and the bottom-s of the filtered values is exact whenever
    >= s values survive the filter (every unseen value lies above the
    threshold) or the threshold saturated.  Under-collection retries the
    whole wave at a higher boost; the pool path remains the final
    fallback.  Returns ``(values, counts)``, or ``None`` when the ladder
    stays under-collected.
    """
    import jax

    from fpmash_tpu.ops.kmers import classic_sketch_device
    from fpmash_tpu.parallel.sharded import visible_device_count

    k = p.kmer_size
    s = p.sketch_size
    devices = jax.devices()[: visible_device_count()]
    starts = [pos for pos in starts if min(pos + size, n) - pos >= k]

    bufs_d: list[tuple] = []

    def dispatch_all(boost, slots):
        if not bufs_d:  # upload once; boost retries reuse device buffers
            for ci, pos in enumerate(starts):
                end = min(pos + size, n)
                buf = np.zeros(size, np.uint8)
                buf[: end - pos] = np.frombuffer(blob[pos:end], np.uint8)
                length = (end - pos) if end == n else (step + k - 1)
                dev = devices[ci % len(devices)]
                bufs_d.append(
                    (
                        jax.device_put(buf, dev),
                        jax.device_put(np.int32(length), dev),
                    )
                )
        return [
            classic_sketch_device(
                buf_d,
                len_d,
                k=k,
                s=s,
                noncanonical=p.noncanonical,
                preserve_case=p.preserve_case,
                seed=p.seed,
                boost=boost,
                out_slots=slots,
            )
            for buf_d, len_d in bufs_d
        ]

    for boost in (1, 4, 16):
        slots = 16 * s * boost
        sat = (8.0 * s * boost) / max(size - (k - 1), 1) >= 1.0
        wave = dispatch_all(boost, slots)
        chunks = []
        for values, counts, nv, ok in wave:
            if not bool(ok):  # slot overflow: whole wave retries
                chunks = None
                break
            nv = int(nv)
            chunks.append(
                (np.asarray(values)[:nv], np.asarray(counts)[:nv])
            )
        if chunks is None:
            continue
        v = (
            np.concatenate([x[0] for x in chunks])
            if chunks
            else np.zeros(0, np.uint64)
        )
        c = (
            np.concatenate([x[1] for x in chunks]).astype(np.uint64)
            if chunks
            else np.zeros(0, np.uint64)
        )
        if len(v):
            order = np.argsort(v, kind="stable")
            v, c = v[order], c[order]
            is_start = np.concatenate([[True], v[1:] != v[:-1]])
            grp = np.cumsum(is_start) - 1
            csum = np.zeros(int(grp[-1]) + 1, np.uint64)
            np.add.at(csum, grp, c)
            vals = v[is_start]
            keep = csum >= p.min_cov
            vals_f, counts_f = vals[keep], csum[keep]
        else:
            vals_f = np.zeros(0, np.uint64)
            counts_f = np.zeros(0, np.uint64)
        if len(vals_f) >= s or sat:
            return vals_f[:s], counts_f[:s].astype(np.uint32)
    return None


def _chunk_pool_bottom_k(
    blob: bytes, pos: int, size: int, n: int, p: SketchParams, need_counts: bool
):
    """Exact per-chunk fallback for a direct-route chunk whose boost
    ladder under-collected: hash the chunk's windows (one device pass,
    this chunk's pool only comes down), chunk-local bottom-s on host.

    Chunk ownership matches the direct route: valid windows start at
    0..step-1 (window validity ``start <= length - k`` already excludes
    the k-1 overlap, whose windows belong to the next chunk).
    """
    import jax.numpy as jnp

    from fpmash_tpu.ops.bottomk import bottom_k_host
    from fpmash_tpu.ops.kmers import kmer_hashes

    k = p.kmer_size
    end = min(pos + size, n)
    buf = np.zeros(size, np.uint8)
    buf[: end - pos] = np.frombuffer(blob[pos:end], np.uint8)
    length = (end - pos) if end == n else size
    h, valid = kmer_hashes(
        jnp.asarray(buf),
        jnp.int32(length),
        alphabet=p.alphabet,
        k=k,
        noncanonical=p.noncanonical,
        preserve_case=p.preserve_case,
        seed=p.seed,
        use64=True,
    )
    hashes = np.asarray(h)[np.asarray(valid)]
    values, counts = bottom_k_host(hashes, p.sketch_size, 1)
    if not need_counts:
        counts = np.ones_like(counts)
    return values, counts.astype(np.uint32), len(values)


def _kmer_hash_pool(seqs: list[str], p: SketchParams, backend: str) -> np.ndarray:
    """All valid k-mer hashes of all sequences, as one flat u64 pool.

    Device path: all sequences concatenate into ONE buffer separated by
    ``k-1`` NUL bytes (outside every alphabet), so windows spanning record
    boundaries are invalid automatically and the whole pool hashes in a
    single kernel launch.  The buffer pads to a power-of-two bucket so
    repeated calls hit the jit cache.
    """
    if not seqs:
        return np.zeros(0, np.uint64)
    if backend == "scalar" or (backend == "auto" and sum(map(len, seqs)) < 512):
        return _kmer_hash_pool_scalar(seqs, p)

    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import kmer_hashes

    k = p.kmer_size
    sep = b"\x00" * (k - 1)
    blob = sep.join(s.encode("ascii", "replace") if isinstance(s, str) else bytes(s) for s in seqs)
    n = len(blob)

    # Process in fixed-size chunks (overlapped by k-1) so only a handful of
    # shapes ever compile, regardless of input size.
    import jax

    from fpmash_tpu import route

    CHUNK = route.chunk_bases()
    size = CHUNK if n > (CHUNK >> 2) else _round_up_pow2(n, 4096)
    step = size - (k - 1)

    # assemble all overlapped chunks as one [C, size] batch, then hash the
    # rows in a single vmapped dispatch routed through shard_rows — with
    # multiple visible devices the chunk rows data-parallelize across the
    # mesh (bitwise-identical; zero-length pad rows hash to nothing)
    starts = list(range(0, n, step))
    C = len(starts)
    Cp = _round_up_pow2(C, 1)  # bound the number of compiled shapes
    bufs = np.zeros((Cp, size), np.uint8)
    lens = np.zeros((Cp,), np.int32)  # pad rows stay length 0 -> no hashes
    for ci, pos in enumerate(starts):
        end = min(pos + size, n)
        bufs[ci, : end - pos] = np.frombuffer(blob[pos:end], np.uint8)
        lens[ci] = end - pos

    from fpmash_tpu.parallel.sharded import shard_rows

    def hash_rows(bufs, lens):
        return jax.vmap(
            lambda b, l: kmer_hashes(
                b,
                l,
                alphabet=p.alphabet,
                k=k,
                noncanonical=p.noncanonical,
                preserve_case=p.preserve_case,
                seed=p.seed,
                use64=p.use64,
            )
        )(bufs, lens)

    h, valid = shard_rows(hash_rows, (bufs, lens))
    h = np.asarray(h)
    valid = np.array(valid)
    for ci, pos in enumerate(starts):
        if pos + size < n:
            # windows starting in the overlap belong to the next chunk
            valid[ci, step:] = False
    out = h[valid]
    if not p.use64:
        out = out & np.uint64(0xFFFFFFFF)
    return out


def _kmer_distinct_counts(seqs: list[str], p: SketchParams, backend: str):
    """Distinct hash values + multiplicities of all valid k-mers.

    Device route (DNA alphabet, k <= 32, at least 64 kbases): the pool
    is hashed, sorted, and run-length encoded ON DEVICE (ops.bottomk.
    distinct_counts_planes) and only the distinct prefix comes down —
    instead of downloading the whole 8 B/base pool and np.unique-ing it
    on the host (CommandScreen.cpp:81-151 scale rationale).
    Returns ``(values u64 ascending, counts u32)``.
    """
    total = sum(map(len, seqs))
    if (
        backend != "scalar"
        and set(p.alphabet) == set("ACGT")
        and p.kmer_size <= 32
        and total >= (1 << 16)
    ):
        return _kmer_distinct_counts_device(seqs, p)
    pool = np.asarray(_kmer_hash_pool(seqs, p, backend), np.uint64)
    return np.unique(pool, return_counts=True)


def _kmer_distinct_counts_device(seqs: list[str], p: SketchParams):
    import jax.numpy as jnp

    k = p.kmer_size
    sep = b"\x00" * (k - 1)
    blob = sep.join(
        s.encode("ascii", "replace") if isinstance(s, str) else bytes(s)
        for s in seqs
    )
    n = len(blob)
    N = _round_up_pow2(n, 1 << 16)
    buf = np.zeros(N, np.uint8)
    buf[:n] = np.frombuffer(blob, np.uint8)

    vlo, vhi, counts, n_distinct = _distinct_counts_run(
        jnp.asarray(buf),
        jnp.int32(n),
        k=k,
        noncanonical=p.noncanonical,
        preserve_case=p.preserve_case,
        seed=p.seed,
        use64=p.use64,
    )
    nd = int(n_distinct)
    # only the distinct prefix leaves the device
    vlo_h = np.asarray(vlo[:nd], np.uint64)
    vhi_h = np.asarray(vhi[:nd], np.uint64)
    return (vhi_h << np.uint64(32)) | vlo_h, np.asarray(counts[:nd])


_distinct_counts_jit = None


def _distinct_counts_run(
    seq_u8, length, *, k, noncanonical, preserve_case, seed, use64
):
    """Jitted hash -> sort -> run-length distinct counter (built once;
    the jit cache then keys on the static args and shapes)."""
    global _distinct_counts_jit
    if _distinct_counts_jit is None:
        import jax
        import jax.numpy as jnp

        from fpmash_tpu.ops.bottomk import distinct_counts_planes
        from fpmash_tpu.ops.kmers import _kmer_hashes_acgt

        @partial(
            jax.jit,
            static_argnames=(
                "k", "noncanonical", "preserve_case", "seed", "use64"
            ),
        )
        def run(
            seq_u8, length, *, k, noncanonical, preserve_case, seed, use64
        ):
            h1, valid = _kmer_hashes_acgt(
                seq_u8, length, k=k, noncanonical=noncanonical,
                preserve_case=preserve_case, seed=seed,
            )
            h1l = (h1 & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
            h1h = (h1 >> jnp.uint64(32)).astype(jnp.uint32)
            if not use64:
                # 32-bit parameters: hashes are the low plane only, so
                # distinctness must collapse the hi plane
                h1h = jnp.zeros_like(h1h)
            return distinct_counts_planes(h1l, h1h, valid)

        _distinct_counts_jit = run
    return _distinct_counts_jit(
        seq_u8, length, k=k, noncanonical=noncanonical,
        preserve_case=preserve_case, seed=seed, use64=use64,
    )


def _position_hashes(seq: str, p: SketchParams, backend: str) -> np.ndarray:
    """Hash of the k-mer at every start position of ``seq``, in order.

    Matches getMinHashPositions' hashing (Sketch.cpp:837): raw bytes as-is
    — no case folding, no canonical strand selection, and no alphabet
    filtering (the invalid-k-mer skip is commented out in the reference).
    With 32-bit parameters the reference reads the union's ``hash64`` field
    after only ``hash32`` was set (UB); we use the zero-extended 32-bit
    hash, which is the common in-practice value and deterministic.
    """
    k = p.kmer_size
    b = seq.encode("ascii", "replace") if isinstance(seq, str) else bytes(seq)
    n = len(b)
    if n < k:
        return np.zeros(0, np.uint64)
    if backend == "scalar" or (backend == "auto" and n < 4096):
        from fpmash_tpu.scalar.murmur3 import hash_bytes

        out = np.array(
            [hash_bytes(b[i : i + k], seed=p.seed, use64=True) for i in range(n - k + 1)],
            np.uint64,
        )
    else:
        import jax.numpy as jnp

        from fpmash_tpu import route
        from fpmash_tpu.ops.kmers import kmer_hashes

        CHUNK = route.chunk_bases()
        size = CHUNK if n > (CHUNK >> 2) else _round_up_pow2(n, 4096)
        step = size - (k - 1)
        parts = []
        pos = 0
        while pos < n:
            end = min(pos + size, n)
            buf = np.zeros(size, np.uint8)
            buf[: end - pos] = np.frombuffer(b[pos:end], np.uint8)
            h, _ = kmer_hashes(
                jnp.asarray(buf),
                jnp.int32(end - pos),
                alphabet=p.alphabet,
                k=k,
                noncanonical=True,
                preserve_case=True,
                seed=p.seed,
                use64=True,
            )
            keep = min(step, end - pos - k + 1)
            parts.append(np.asarray(h)[:keep])
            pos += step
        out = np.concatenate(parts)[: n - k + 1]
    if not p.use64:
        out = out & np.uint64(0xFFFFFFFF)
    return out


def _kmer_hash_pool_scalar(seqs: list[str], p: SketchParams) -> np.ndarray:
    from fpmash_tpu.ops.kmers import complement_table
    from fpmash_tpu.scalar.murmur3 import hash_bytes

    ctab = complement_table()
    alpha = set(p.alphabet.encode())
    k = p.kmer_size
    out = []
    for seq in seqs:
        s = seq if p.preserve_case else seq.upper()
        b = s.encode("ascii", "replace")
        rc = bytes(ctab[c] for c in b)[::-1]
        n = len(b)
        for i in range(n - k + 1):
            kmer = b[i : i + k]
            if any(c not in alpha for c in kmer):
                continue
            if not p.noncanonical:
                rck = rc[n - i - k : n - i]
                if rck < kmer:
                    kmer = rck
            h = hash_bytes(kmer, seed=p.seed, use64=True)
            out.append(h)
    res = np.array(out, np.uint64) if out else np.zeros(0, np.uint64)
    if not p.use64:
        res = res & np.uint64(0xFFFFFFFF)
    return res


def _bottom_k(hashes: np.ndarray, p: SketchParams, backend: str):
    """Bottom-s distinct + counts over a hash pool; sorted ascending."""
    if p.bloom_bytes > 0 and p.reads:
        # -b: memory-bounded Bloom admission instead of exact counting
        # (MinHashHeap.cpp:78-95); the stream-order pool feeds the filter
        from fpmash_tpu.ops.bloom import bloom_admit_counts

        values, counts = bloom_admit_counts(hashes, p.bloom_bytes)
        return values[: p.sketch_size], counts[: p.sketch_size]
    if backend == "scalar" or (backend == "auto" and len(hashes) < 4096):
        from fpmash_tpu.ops.bottomk import bottom_k_host

        values, counts = bottom_k_host(hashes, p.sketch_size, p.min_cov)
        return values, counts

    import jax.numpy as jnp

    from fpmash_tpu.ops.bottomk import bottom_k_distinct

    n_in = len(hashes)
    N = _round_up_pow2(n_in, 4096)
    pool = np.zeros(N, np.uint64)
    pool[:n_in] = hashes
    valid = np.zeros(N, bool)
    valid[:n_in] = True
    pool_j = jnp.asarray(pool)
    valid_j = jnp.asarray(valid)
    if N > (1 << 17) and p.sketch_size * 16 <= (1 << 16):
        # threshold-filtered fast path (no full sort of the pool); retry
        # with a wider threshold, then fall back to the full sort, if the
        # filter under-collects (non-uniform pool or sparse min_cov)
        from fpmash_tpu.ops.bottomk import bottom_k_threshold

        # multiplicity counts are only consumed with -M/-m/-c; skipping the
        # run-length pass when unused is ~1.6x on the bottom-k stage
        need_counts = bool(p.counts or p.min_cov > 1 or p.target_cov > 0)
        for boost in (1, 8):
            values, counts, n, ok = bottom_k_threshold(
                pool_j, valid_j, s=p.sketch_size, min_cov=p.min_cov,
                boost=boost, need_counts=need_counts,
            )
            if bool(ok):
                n = int(n)
                return np.asarray(values)[:n], np.asarray(counts)[:n]
    values, counts, n = bottom_k_distinct(
        pool_j, valid_j, s=p.sketch_size, min_cov=p.min_cov
    )
    n = int(n)
    return np.asarray(values)[:n], np.asarray(counts)[:n]

#!/usr/bin/env python3
"""Smoke run of fpmash on an NVIDIA GPU, at the sizes its users run.

Drives the two main workflows through the CLI entry point
(``fpmash_tpu.cli.main``), in this one process, and checks every result
against the repository's host models:

1. device: JAX must find a GPU; prints its kind and the card's name and
   power limit (``nvidia-smi``);
2. fp-mash: ``sketch --direct-fp`` (CFL and ICFL_COMB) at the 1,000,000
   shift-window cap, ``info -d``, ``dist -fp`` of a 500-read query;
3. classic Mash: ``sketch`` of 8 multi-contig genomes (1-6 Mbase, k=21,
   s=1000), ``sketch -r -m 2`` of a 10-Mbase FASTQ, ``dist``,
   ``triangle``, a 2,000 x 2,000 ``dist`` of s=1000 sketches, ``screen``;
4. the vendored golden fixtures, run on the device.

``--four`` runs only the four-card phase: the same commands with
``FPMASH_DEVICES=4`` and ``=1`` must write identical bytes.

Usage, from the repository root::

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards

Any failure exits non-zero: a phase that raises, a check that differs, a
route that did not run on the device, or an ``[fpmash] WARNING`` line.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
GOLDEN = os.path.join(ROOT, "tests", "golden")
LUT = np.frombuffer(b"ACGT", np.uint8)
CARD = ""

# section 1 of the workflow: read set that reaches the fingerprint cap
FP_READS, FP_QUERY, READ_LEN = 6700, 500, 150
GENOME_MBASE = (1.0, 1.5, 2.2, 2.5, 3.0, 4.0, 5.0, 6.0)
DIRECT_MBASE = 2.1  # inputs above 2**21 bases take the direct route
FASTQ_READS = 66_667  # ~10 Mbase of 150-bp reads
SUBSET_READS = 14_000  # 2.1 Mbase, checked whole against the host model
N_SKETCHES = 2000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Spy:
    """Counts calls of module attributes, to prove which route ran."""

    def __init__(self):
        self.calls = collections.Counter()

    def wrap(self, module, name: str):
        orig = getattr(module, name)

        @functools.wraps(orig)
        def counted(*a, **kw):
            self.calls[name] += 1
            return orig(*a, **kw)

        setattr(module, name, counted)

    def ran(self, name: str) -> int:
        n = self.calls[name]
        self.calls[name] = 0
        return n


def cli(*argv) -> str:
    """One CLI command in this process; returns its standard output."""
    from fpmash_tpu.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    if "[fpmash] WARNING" in err.getvalue():
        raise RuntimeError(f"fallback warning in {argv}: {err.getvalue()}")
    if rc != 0:
        raise RuntimeError(f"{argv} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue()


def cold_warm(fn):
    """Run ``fn`` twice: (first-call seconds incl. compiles, warm seconds,
    result of the warm call)."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return cold, time.perf_counter() - t0, out


def report(name: str, sizes: str, route: str, cold: float, warm=None):
    w = "not run" if warm is None else f"{warm:.3f} s"
    print(
        f"phase {name}: {sizes}; route {route}; cold {cold:.3f} s, "
        f"warm {w}; card {CARD}",
        flush=True,
    )


def path(name: str) -> str:
    return os.path.join(WORK, name)


# ---------------------------------------------------------------------- #
# inputs (seeded)
# ---------------------------------------------------------------------- #


def random_dna(rng, n: int) -> np.ndarray:
    return LUT[rng.integers(0, 4, size=n)]


def mutate(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Substitute a ``rate`` fraction of bases by a different base."""
    out = seq.copy()
    pos = np.nonzero(rng.random(len(seq)) < rate)[0]
    code = np.searchsorted(LUT, out[pos])
    out[pos] = LUT[(code + rng.integers(1, 4, size=len(pos))) % 4]
    return out


def write_fasta(fname: str, records):
    with open(fname, "w") as f:
        for header, seq in records:
            s = seq.tobytes().decode()
            f.write(f">{header}\n")
            f.write("\n".join(s[i : i + 80] for i in range(0, len(s), 80)))
            f.write("\n")


def write_fastq(fname: str, reads: np.ndarray, tag: str):
    qual = "I" * reads.shape[1]
    with open(fname, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{tag}.{i}\n{r.tobytes().decode()}\n+\n{qual}\n")


# ---------------------------------------------------------------------- #
# phase 2: fp-mash
# ---------------------------------------------------------------------- #


def window_hashes(word: str, family: str) -> int:
    from fpmash_tpu.scalar.lyndon import FACTORIZATIONS
    from fpmash_tpu.scalar.murmur3 import hash_u64_vector

    fac = [len(f) for f in FACTORIZATIONS[family](word) if f not in ("<<", ">>")]
    return hash_u64_vector(fac, seed=42, use64=False)


def check_sampled_windows(msh: str, reads: np.ndarray, family: str) -> int:
    """First and last window of every 32-window block (one Triton
    program) against the scalar factorization + hash."""
    from fpmash_tpu.models.sketch import LIMIT_READ_FINGERPRINT
    from fpmash_tpu.utils.msh import read_msh

    flat = np.concatenate([r.hashes32 for r in read_msh(msh).references])
    assert len(flat) == LIMIT_READ_FINGERPRINT, len(flat)
    sample = sorted(set(range(0, len(flat), 32)) | set(range(31, len(flat), 32)))
    for g in sample:
        r, i = divmod(g, READ_LEN)
        s = reads[r].tobytes().decode()
        word = (s + s[:99])[i : i + 100]
        assert int(flat[g]) == window_hashes(word, family), (family, g)
    return len(sample)


def phase_fp(spy: Spy):
    from fpmash_tpu.models.distance import compare_sketches
    from fpmash_tpu.models.sketch import LIMIT_READ_FINGERPRINT, Sketch
    from fpmash_tpu.scalar.stats import format_g

    n_refs = -(-LIMIT_READ_FINGERPRINT // READ_LEN)  # reads within the cap
    rng = np.random.default_rng(1)
    reads = random_dna(rng, FP_READS * READ_LEN).reshape(FP_READS, READ_LEN)
    # query reads: lightly mutated copies of reference reads, so that many
    # (reference, query) pairs pass the distance cut
    qsrc = rng.choice(n_refs, size=FP_QUERY, replace=False)
    query = np.stack([mutate(rng, reads[i], 0.003) for i in qsrc])
    write_fasta(path("fp.fasta"), ((f"r{i} g{i}", r) for i, r in enumerate(reads)))
    write_fasta(path("fq.fasta"), ((f"q{i} h{i}", r) for i, r in enumerate(query)))

    for family, route in (("CFL", "triton"), ("ICFL_COMB", "xla-split")):
        prefix = path(f"fp_{family}")
        argv = ["sketch", "--direct-fp", "--factorization", family, "-o",
                prefix, path("fp.fasta")]
        cold, warm, _ = cold_warm(lambda: cli(*argv))
        name = ("fingerprint_hashes_stream" if family == "CFL"
                else "factor_lengths_device")
        assert spy.ran(name) >= 2, f"{family}: {name} did not run"
        n = check_sampled_windows(prefix + ".msh", reads, family)
        if family == "CFL":
            # the text route: scalar fingerprints -> sketch -fp, same bytes
            cli("fingerprint", "--path", WORK, "--fasta", "fp.fasta",
                "--type_factorization", "CFL", "--rev_comb", "true",
                "--fact", "no_create", "--backend", "scalar")
            cli("sketch", "-fp", path("fingerprint_CFL.txt"), "-o", path("fp_txt"))
            with open(prefix + ".msh", "rb") as a, open(path("fp_txt.msh"), "rb") as b:
                assert a.read() == b.read(), "CFL: device .msh != text route"
        report(f"fp-mash sketch --direct-fp {family}",
               f"{FP_READS} reads x {READ_LEN} bp, "
               f"{LIMIT_READ_FINGERPRINT} windows (cap), "
               f"{n} windows checked", route, cold, warm)

    from fpmash_tpu.utils.info_json import load_info_json

    info = load_info_json(cli("info", "-d", path("fp_CFL.msh")))
    assert len(info["sketches"]) == n_refs

    cli("sketch", "--direct-fp", "-o", path("fq"), path("fq.fasta"))
    assert spy.ran("fingerprint_hashes_stream") == 1
    argv = ["dist", "-fp", "-d", "0.5", path("fp_CFL.msh"), path("fq.msh")]
    cold, warm, out = cold_warm(lambda: cli(*argv))
    assert spy.ran("pairwise_walk_common_denom") >= 1, "dist -fp walk did not run"
    lines = {}
    for ln in out.splitlines():
        r, q, d, p, sd = ln.split("\t")
        lines[(r, q)] = (d, p, sd)
    ref, qry = Sketch(), Sketch()
    ref.load_msh(path("fp_CFL.msh"))
    qry.load_msh(path("fq.msh"))
    pairs = [(int(s), q) for q, s in enumerate(qsrc[:500])]
    pairs += list(zip(rng.integers(0, len(ref), 500), rng.integers(0, len(qry), 500)))
    passed = 0
    for ri, qi in pairs:
        r, q = ref.references[ri], qry.references[qi]
        res = compare_sketches(r.hashes, q.hashes, r.length, q.length, 1000,
                               1, ref.params.kmer_space, 0.5, 1.0)
        got = lines.get((r.name, q.name))
        if res.passed:
            passed += 1
            want = (format_g(res.distance), format_g(res.pvalue),
                    f"{res.numer}/{res.denom}")
            assert got == want, (r.name, q.name, got, want)
        else:
            assert got is None, (r.name, q.name, got)
    assert passed >= min(FP_QUERY, 500) // 2, passed  # most diagonal pairs
    report("fp-mash dist -fp",
           f"{len(ref)} x {len(qry)} fingerprint sketches, "
           f"{len(pairs)} pairs checked ({passed} reported)",
           "xla walk", cold, warm)


# ---------------------------------------------------------------------- #
# phase 3: classic Mash
# ---------------------------------------------------------------------- #


def make_genomes(rng):
    ancestor = random_dna(rng, int(GENOME_MBASE[-1] * 1e6))
    genomes = []
    for g, mb in enumerate(GENOME_MBASE):
        seq = mutate(rng, ancestor[: int(mb * 1e6)], 0.002 * (g + 1))
        cuts = np.sort(rng.choice(np.arange(1, len(seq)), size=2 + g, replace=False))
        contigs = np.split(seq, cuts)
        write_fasta(path(f"g{g}.fna"),
                    ((f"g{g}_c{c} genome {g}", s) for c, s in enumerate(contigs)))
        genomes.append(contigs)
    return genomes


def host_sketch(seqs, min_cov=1):
    from fpmash_tpu.models.sketch import SketchParams, _kmer_hash_pool_scalar
    from fpmash_tpu.ops.bottomk import bottom_k_host

    pool = _kmer_hash_pool_scalar(seqs, SketchParams())
    return pool, bottom_k_host(pool, 1000, min_cov)


def make_sketch_sets(rng):
    """Two .msh files of N_SKETCHES s=1000 sketches in 40 clusters of
    near-identical members (so some pairs pass a distance cut)."""
    from fpmash_tpu.models.sketch import Reference, Sketch

    bases = [np.unique(rng.integers(0, 1 << 64, size=1100, dtype=np.uint64))[:1000]
             for _ in range(40)]
    for tag in ("sa", "sb"):
        sk = Sketch()
        for i in range(N_SKETCHES):
            h = bases[i % 40].copy()
            swap = rng.random(len(h)) < 0.05
            h[swap] = rng.integers(0, 1 << 64, size=int(swap.sum()), dtype=np.uint64)
            h = np.unique(h)[:1000]
            sk.references.append(
                Reference(name=f"{tag}{i}", length=5_000_000, hashes=h)
            )
        sk._create_index()
        sk.write_msh(path(tag + ".msh"))


def phase_classic(spy: Spy):
    from fpmash_tpu.models.distance import compare_sketches
    from fpmash_tpu.models.sketch import Sketch, _kmer_distinct_counts
    from fpmash_tpu.scalar.stats import format_g
    from fpmash_tpu.utils.msh import read_msh

    rng = np.random.default_rng(2)
    genomes = make_genomes(rng)
    files = [path(f"g{g}.fna") for g in range(len(genomes))]
    argv = ["sketch", "-o", path("genomes"), *files]
    cold, warm, _ = cold_warm(lambda: cli(*argv))
    n_direct = spy.ran("classic_sketch_device")
    assert n_direct >= 2 * sum(mb > DIRECT_MBASE for mb in GENOME_MBASE), n_direct
    # one whole genome on the direct route against the host model
    g = min(i for i, mb in enumerate(GENOME_MBASE) if mb > DIRECT_MBASE)
    _, (hv, _) = host_sketch([c.tobytes().decode() for c in genomes[g]])
    got = read_msh(path("genomes.msh")).references[g]
    assert np.array_equal(np.asarray(got.hashes64), hv), "genome sketch differs"
    report("classic sketch",
           f"{len(files)} genomes, {sum(GENOME_MBASE)} Mbase, k=21 s=1000",
           "xla direct (>= 2 Mbase) + pool", cold, warm)

    # reads: a 2.1-Mbase high-coverage subset first, then 1.67x of genome 7
    src = np.concatenate(genomes[-1])
    starts = np.concatenate([
        rng.integers(0, min(300_000, len(src)) - READ_LEN, size=SUBSET_READS),
        rng.integers(0, len(src) - READ_LEN, size=FASTQ_READS - SUBSET_READS),
    ])
    reads = np.stack([mutate(rng, src[s : s + READ_LEN], 0.01) for s in starts])
    write_fastq(path("reads.fastq"), reads, "R")
    write_fastq(path("subset.fastq"), reads[:SUBSET_READS], "R")
    argv = ["sketch", "-r", "-m", "2", "-o", path("reads"), path("reads.fastq")]
    cold, warm, _ = cold_warm(lambda: cli(*argv))
    assert spy.ran("classic_sketch_device") >= 2, "reads mode left the device"
    cli("sketch", "-r", "-m", "2", "-o", path("subset"), path("subset.fastq"))
    assert spy.ran("classic_sketch_device") >= 1, "subset reads left the device"
    sub = [r.tobytes().decode() for r in reads[:SUBSET_READS]]
    pool, (hv, hc) = host_sketch(sub, min_cov=2)
    got = read_msh(path("subset.msh")).references[0]
    assert np.array_equal(np.asarray(got.hashes64), hv), "reads hashes differ"
    assert np.array_equal(np.asarray(got.counts32), hc), "reads counts differ"
    report("classic sketch -r -m 2",
           f"{FASTQ_READS} reads x {READ_LEN} bp ({FASTQ_READS * READ_LEN} bases); "
           f"{SUBSET_READS}-read subset checked whole",
           "xla direct collect-all", cold, warm)

    argv = ["dist", path("genomes.msh"), path("genomes.msh")]
    cold, warm, out = cold_warm(lambda: cli(*argv))
    assert spy.ran("pairwise_common_denom") >= 1, "dist did not run on device"
    assert out == cli(*argv, "--backend", "scalar"), "dist differs from host"
    tri = cli("triangle", path("genomes.msh"))
    assert tri == cli("triangle", "--backend", "scalar", path("genomes.msh"))
    report("classic dist + triangle", f"{len(files)} x {len(files)} genomes",
           "xla compare tile", cold, warm)

    make_sketch_sets(rng)
    argv = ["dist", "-d", "0.1", path("sa.msh"), path("sb.msh")]
    cold, warm, out = cold_warm(lambda: cli(*argv))
    assert spy.ran("pairwise_common_denom") >= 1, "compare tile did not run"
    lines = {}
    for ln in out.splitlines():
        r, q, d, p, sd = ln.split("\t")
        lines[(r, q)] = (d, p, sd)
    a, b = Sketch(), Sketch()
    a.load_msh(path("sa.msh"))
    b.load_msh(path("sb.msh"))
    pairs = list(zip(rng.integers(0, N_SKETCHES, 1000), rng.integers(0, N_SKETCHES, 1000)))
    pairs[:500] = [(i, (i + 40 * rng.integers(0, 49)) % N_SKETCHES)
                   for i in rng.integers(0, N_SKETCHES, 500)]  # same cluster
    passed = 0
    for ri, qi in pairs:
        r, q = a.references[ri], b.references[qi]
        res = compare_sketches(r.hashes, q.hashes, r.length, q.length, 1000, 21,
                               a.params.kmer_space, 0.1, 1.0)
        got = lines.get((r.name, q.name))
        if res.passed:
            passed += 1
            assert got == (format_g(res.distance), format_g(res.pvalue),
                           f"{res.numer}/{res.denom}"), (r.name, q.name)
        else:
            assert got is None, (r.name, q.name)
    assert passed >= 500, passed
    report(f"classic dist {N_SKETCHES} x {N_SKETCHES}",
           f"{N_SKETCHES} x {N_SKETCHES} sketches s=1000, {len(pairs)} pairs checked",
           "xla compare tile", cold, warm)

    argv = ["screen", path("genomes.msh"), path("reads.fastq")]
    cold, warm, out = cold_warm(lambda: cli(*argv))
    assert spy.ran("_kmer_distinct_counts_device") >= 2, "screen left the device"
    top = max(out.splitlines(), key=lambda ln: float(ln.split("\t")[0]))
    assert top.split("\t")[4] == files[-1], top
    # the device distinct count against np.unique of the host pool
    ref = Sketch()
    ref.load_msh(path("genomes.msh"))
    v, c = _kmer_distinct_counts(sub, ref.params, "auto")
    assert spy.ran("_kmer_distinct_counts_device") == 1
    wv, wc = np.unique(pool, return_counts=True)
    assert np.array_equal(v, wv) and np.array_equal(c.astype(np.int64), wc)
    report("classic screen", f"{FASTQ_READS * READ_LEN} query bases vs "
           f"{len(files)} genomes; distinct counts of {len(pool)} k-mers checked",
           "xla distinct count", cold, warm)


# ---------------------------------------------------------------------- #
# phase 4: goldens on the device
# ---------------------------------------------------------------------- #


def golden_genomes_msh() -> str:
    from fpmash_tpu.models.sketch import Sketch

    ref = Sketch()
    for i in (1, 2, 3):
        ref.load_msh(os.path.join(GOLDEN, "mash_ref", f"genome{i}.fna.msh"))
    for i, r in enumerate(ref.references, 1):
        r.name = f"genome{i}.fna"
    ref.write_msh(path("golden_genomes.msh"))
    return path("golden_genomes.msh")


def same_msh(got: str, want: str, comment_cr: bool = False):
    """Decoded .msh equality: parameters and every reference field (the
    capnp framing of the vendored files differs from ours byte-wise)."""
    from fpmash_tpu.utils.msh import read_msh

    a, b = read_msh(got), read_msh(want)
    for f in ("kmer_size", "min_hashes_per_window", "alphabet", "hash_seed",
              "noncanonical"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.references) == len(b.references)
    for x, y in zip(a.references, b.references):
        cy = y.comment.replace("\r", "") if comment_cr else y.comment
        assert (x.name, x.comment, x.length) == (y.name, cy, y.length)
        for f in ("hashes32", "hashes64", "counts32"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                assert np.array_equal(np.asarray(u), np.asarray(v)), f


def phase_goldens(spy: Spy):
    reads1 = os.path.join(GOLDEN, "new_data", "reads1.fastq")
    reads2 = os.path.join(GOLDEN, "new_data", "reads2.fastq")
    t0 = time.perf_counter()
    cli("sketch", "-r", "-I", "reads", "--backend", "jax", "-o", path("gold_reads"),
        reads1, reads2)
    same_msh(path("gold_reads.msh"), os.path.join(GOLDEN, "new_data", "reads.msh"),
             comment_cr=True)
    cli("sketch", "--direct-fp", "-o", path("gold_dna3"),
        os.path.join(GOLDEN, "cfl", "DNA3.fasta"))
    assert spy.ran("fingerprint_hashes_stream") == 1
    same_msh(path("gold_dna3.msh"), os.path.join(GOLDEN, "cfl", "DNA3-sketch.msh"))
    genomes = golden_genomes_msh()
    out = cli("dist", "--backend", "jax", genomes,
              os.path.join(GOLDEN, "new_data", "reads.msh"))
    assert out == open(os.path.join(GOLDEN, "mash_ref", "genomes.dist")).read()
    out = cli("screen", "--backend", "jax", genomes, reads1, reads2)
    assert spy.ran("_kmer_distinct_counts_device") == 1
    assert out == open(os.path.join(GOLDEN, "mash_ref", "screen_ref.txt")).read()
    dt = time.perf_counter() - t0
    report("goldens", "reads.msh, DNA3-sketch.msh, genomes.dist, screen_ref.txt",
           "device (--backend jax)", dt)


# ---------------------------------------------------------------------- #
# phase 5: four cards
# ---------------------------------------------------------------------- #


def phase_four(spy: Spy):
    import jax

    import __graft_entry__

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    rng = np.random.default_rng(1)
    reads = random_dna(rng, FP_READS * READ_LEN).reshape(FP_READS, READ_LEN)
    write_fasta(path("fp.fasta"), ((f"r{i} g{i}", r) for i, r in enumerate(reads)))
    make_genomes(np.random.default_rng(2))
    make_sketch_sets(np.random.default_rng(3))
    genomes = [path(f"g{g}.fna") for g in range(len(GENOME_MBASE))]
    outputs = {}
    for d in ("4", "1"):
        os.environ["FPMASH_DEVICES"] = d
        t0 = time.perf_counter()
        cli("sketch", "--direct-fp", "-o", path(f"fp{d}"), path("fp.fasta"))
        cli("sketch", "-o", path(f"genomes{d}"), *genomes)
        dist = cli("dist", "-d", "0.1", path("sa.msh"), path("sb.msh"))
        with open(path(f"fp{d}.msh"), "rb") as f1, open(path(f"genomes{d}.msh"), "rb") as f2:
            outputs[d] = (f1.read(), f2.read(), dist)
        report(f"four-card FPMASH_DEVICES={d}",
               f"fp cap + 8 genomes + {N_SKETCHES} x {N_SKETCHES} dist",
               "shard_map dp mesh" if d == "4" else "one device",
               time.perf_counter() - t0)
    os.environ.pop("FPMASH_DEVICES")
    for name, a, b in zip(("fp", "classic", "dist"), outputs["4"], outputs["1"]):
        assert a == b, f"{name}: FPMASH_DEVICES=4 and =1 differ"
    __graft_entry__.dryrun_multichip(4)
    for dev in jax.devices():
        stats = dev.memory_stats() or {}
        print(f"device {dev.id}: peak {stats.get('peak_bytes_in_use', 0)} bytes, "
              f"in use {stats.get('bytes_in_use', 0)} bytes")
    print("four-card outputs byte-identical to one card: fp, classic, dist")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card identity phase")
    args = ap.parse_args(argv)

    import jax

    from fpmash_tpu import route

    if route.platform() != "gpu":
        print("chip_smoke: JAX found no GPU", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    CARD = card_line()
    print(f"device: {dev.device_kind}; {len(jax.devices())} visible; card {CARD}")

    from fpmash_tpu.models import sketch
    from fpmash_tpu.ops import compare, factorize, fused_pallas, kmers, walk

    spy = Spy()
    spy.wrap(fused_pallas, "fingerprint_hashes_stream")
    spy.wrap(factorize, "factor_lengths_device")
    spy.wrap(kmers, "classic_sketch_device")
    spy.wrap(compare, "pairwise_common_denom")
    spy.wrap(walk, "pairwise_walk_common_denom")
    spy.wrap(sketch, "_kmer_distinct_counts_device")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.four:
            phase_four(spy)
        else:
            phase_fp(spy)
            phase_classic(spy)
            phase_goldens(spy)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark: fingerprint sketching throughput (the `sketch -fp` hot path)
plus the other device routes, each through the production route.

Every number is wall clock around work that ends in ``block_until_ready``
(or a host fetch), after one warm-up call that compiles; the reported rate
is the median over ``REPS`` timed calls.  Any failure fails the run.  The
output names the device it ran on.

Prints ONE JSON line:
  {"metric": "sketched_bases_per_s", "value": N, "unit": "bases/s",
   "vs_baseline": device_over_scalar_cpu_ratio, "device": {...},
   "extra": {...}}
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPS = 5
LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _median_s(fn, *args) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _bench_fingerprint(B: int = 1 << 20, W: int = 100) -> float:
    """Shift windows -> CFL factor lengths -> MurmurHash3, on the route
    ``fpmash_tpu.route.cfl_kernel`` picks.  Returns bases/s."""
    import jax
    import jax.numpy as jnp

    from fpmash_tpu import route
    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_stream
    from fpmash_tpu.ops.lyndon import cfl_lengths_onehot, windows_from_stream
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    rng = np.random.default_rng(0)
    stream = jnp.asarray(LUT[rng.integers(0, 4, size=B + W)])
    starts = jnp.arange(B, dtype=jnp.int32)
    lengths = jnp.full((B,), W, jnp.int32)

    if route.cfl_kernel() == "triton":
        def fn(s, st, ln):
            return fingerprint_hashes_stream(s, st, ln, L=W, seed=42)
    else:
        @jax.jit
        def fn(s, st, ln):
            fl, fc = cfl_lengths_onehot(windows_from_stream(s, st, ln, L=W), ln)
            return murmur3_u64_batch(fl.astype(jnp.uint64), fc, seed=42)[0]

    return B * W / _median_s(fn, stream, starts, lengths)


def _scalar_bases_per_s(W: int = 100, n: int = 2048) -> float:
    """Reference-equivalent scalar front-end (per-window Python Duval +
    hash, lyn2vec.py:40) on a sample."""
    from fpmash_tpu.scalar.lyndon import cfl
    from fpmash_tpu.scalar.murmur3 import hash_u64_vector

    rng = np.random.default_rng(1)
    sample = [LUT[rng.integers(0, 4, size=W)].tobytes().decode() for _ in range(n)]
    t0 = time.perf_counter()
    for s in sample:
        hash_u64_vector([len(f) for f in cfl(s)], seed=42, use64=False)
    return n * W / (time.perf_counter() - t0)


def _bench_classic(N: int = 1 << 24, k: int = 21) -> float:
    """Classic k=21, s=1000 sketch of one 16-Mbase chunk
    (ops.kmers.classic_sketch_device).  Returns bases/s."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import classic_sketch_device

    seq = jnp.asarray(LUT[np.random.default_rng(2).integers(0, 4, size=N)])

    def fn(s):
        return classic_sketch_device(s, jnp.int32(N), k=k, s=1000, seed=42)

    return N / _median_s(fn, seq)


def _bench_screen_distinct(N: int = 1 << 22, k: int = 21) -> float:
    """screen's device distinct count on a coverage-8 pool.  Bases/s."""
    import jax.numpy as jnp

    from fpmash_tpu.models.sketch import _distinct_counts_run

    piece = LUT[np.random.default_rng(12).integers(0, 4, size=N // 8)]
    buf = jnp.asarray(np.tile(piece, 8))

    def fn(b):
        return _distinct_counts_run(
            b, jnp.int32(N), k=k, noncanonical=False, preserve_case=False,
            seed=42, use64=True,
        )

    return N / _median_s(fn, buf)


def _bench_compare(R: int = 256, S: int = 1000) -> float:
    """All-pairs compare tile (R x R sorted s=1000 sketches).  Pairs/s."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import pairwise_common_denom

    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 1 << 62, size=(R, S + 64), dtype=np.uint64), 1)
    ref = jnp.asarray(a[:, :S])
    lens = jnp.full((R,), S, jnp.int32)

    def fn(r):
        return pairwise_common_denom(r, lens, r, lens, sketch_size=S)

    return R * R / _median_s(fn, ref)


def _bench_walk(R: int = 256, L: int = 64) -> float:
    """Unsorted fingerprint merge-join walk (`dist -fp`).  Pairs/s."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.walk import pairwise_walk_common_denom

    rng = np.random.default_rng(4)
    ref = jnp.asarray(rng.integers(0, 1 << 32, size=(R, L), dtype=np.uint64))
    lens = jnp.asarray(rng.integers(1, L + 1, size=R).astype(np.int32))

    def fn(r):
        return pairwise_walk_common_denom(r, lens, r, lens, sketch_size=1000)

    return R * R / _median_s(fn, ref)


def _cli_seconds(argv_list) -> float:
    """Median wall clock of a CLI command sequence, after one warm run."""
    from fpmash_tpu.cli import main as cli_main

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            for argv in argv_list:
                assert cli_main(argv) == 0, argv

    run()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _bench_e2e(td: str, n_reads: int = 256, read_len: int = 2000):
    """`sketch --direct-fp` of two FASTAs + `dist -fp`, and a classic
    `sketch` of an 8-Mbase genome, through the CLI.  Bases/s each."""
    rng = np.random.default_rng(7)
    for tag in ("a", "b"):
        with open(os.path.join(td, tag + ".fasta"), "w") as f:
            for i in range(n_reads):
                seq = LUT[rng.integers(0, 4, size=read_len)].tobytes().decode()
                f.write(f">{tag}{i}\n{seq}\n")
    p = lambda name: os.path.join(td, name)  # noqa: E731
    fp_s = _cli_seconds([
        ["sketch", "--direct-fp", p("a.fasta"), "-o", p("a")],
        ["sketch", "--direct-fp", p("b.fasta"), "-o", p("b")],
        ["dist", "-fp", p("a.msh"), p("b.msh")],
    ])
    n_bases = 8_000_000
    with open(p("g.fasta"), "w") as f:
        f.write(">g synthetic\n")
        seq = LUT[rng.integers(0, 4, size=n_bases)].tobytes().decode()
        for i in range(0, n_bases, 80):
            f.write(seq[i : i + 80] + "\n")
    classic_s = _cli_seconds([["sketch", p("g.fasta"), "-o", p("g")]])
    return 2 * n_reads * read_len / fp_s, n_bases / classic_s


def main() -> int:
    import jax

    import fpmash_tpu  # noqa: F401  (x64 + compile cache)

    dev = jax.devices()[0]
    device_rate = _bench_fingerprint()
    cpu_rate = _scalar_bases_per_s()
    extra = {
        "classic_sketch_bases_per_s": round(_bench_classic()),
        "screen_distinct_bases_per_s": round(_bench_screen_distinct()),
        "compare_pairs_per_s": round(_bench_compare()),
        "fp_walk_pairs_per_s": round(_bench_walk()),
    }
    with tempfile.TemporaryDirectory() as td:
        fp_rate, classic_rate = _bench_e2e(td)
    extra["e2e_fp_cli_bases_per_s"] = round(fp_rate)
    extra["e2e_classic_cli_bases_per_s"] = round(classic_rate)
    print(json.dumps({
        "metric": "sketched_bases_per_s",
        "value": round(device_rate),
        "unit": "bases/s",
        "vs_baseline": round(device_rate / cpu_rate, 2),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

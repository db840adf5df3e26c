"""The one place that decides, per platform, which device route runs.

Every device operation has one route per supported platform, chosen here
and nowhere else: call sites ask this module instead of reading
``jax.default_backend()`` themselves.  Two platforms are supported:

* ``cpu`` — plain XLA everywhere (the test platform; Pallas kernels run
  only in interpret mode, called directly by their tests);
* ``gpu`` — plain XLA, plus the Triton CFL fingerprint kernel
  (:mod:`fpmash_tpu.ops.fused_pallas`).

Any other platform raises: a route that was never chosen for a device
must not be guessed.
"""

from __future__ import annotations

SUPPORTED = ("cpu", "gpu")


def platform(name: str | None = None) -> str:
    """The active JAX platform (or ``name``), checked against
    :data:`SUPPORTED`."""
    if name is None:
        import jax

        name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(
            f"fpmash: unsupported JAX platform {name!r} "
            f"(supported: {', '.join(SUPPORTED)})"
        )
    return name


def cfl_kernel(name: str | None = None) -> str:
    """Route of the CFL fingerprint step (Duval factor lengths + MurmurHash3
    per shift window): ``"triton"`` (the fused Pallas kernel) on the GPU,
    ``"xla"`` (``cfl_lengths_onehot`` + ``murmur3_u64_batch``) on the CPU."""
    return "triton" if platform(name) == "gpu" else "xla"


def chunk_bases(name: str | None = None) -> int:
    """Bases per device call for the chunked k-mer hash pool
    (``models.sketch._kmer_hash_pool`` / ``_position_hashes``).  XLA:CPU
    compile time grows with the shape, so the CPU chunk is small.  On an
    H100 (400 W limit) a 10-Mbase pool took 0.127 s in 4-Mbase chunks and
    0.133 s in 16-Mbase chunks (warm medians)."""
    return (1 << 15) if platform(name) == "cpu" else (1 << 22)


def compare_tile(name: str | None = None) -> int:
    """Sketches per side of one all-pairs compare tile
    (``ops.compare.all_pairs_common_denom``).  The XLA merge materializes
    ``[tile, tile, 2S]`` u64 stages, so the tile bounds device memory.  On
    an H100 (400 W limit), 2,000 x 2,000 s=1000 sketches took 0.76 / 0.74 /
    0.73 s with 128 / 256 / 512 tiles, whose programs need 0.5 / 2.1 /
    8.6 GB of temporaries: 256 is within 1% of the fastest at a quarter of
    its memory."""
    return 128 if platform(name) == "cpu" else 256

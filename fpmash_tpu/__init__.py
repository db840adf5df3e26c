"""fpmash_tpu — a JAX sketch-and-distance framework for accelerators.

A from-scratch rebuild of the fp-mash pipeline (lyn2vec Lyndon-factorization
fingerprints + a MinHash sketch/distance engine) that runs its hot paths on
an accelerator (an NVIDIA GPU; the CPU runs the same code for tests):

* the compute path (factorization, MurmurHash3, bottom-k selection, pairwise
  sketch comparison) is batched JAX/XLA, with a Pallas (Triton) kernel for
  the CFL fingerprint hot op; ``fpmash_tpu.route`` picks each route,
* scale-out is ``jax.sharding.Mesh`` + ``shard_map`` data parallelism with
  XLA collectives, replacing the reference's pthread pool / fork pool,
* host-side glue (CLI, FASTA/fingerprint/.msh IO, stats) is plain Python with
  optional C++ fast paths under ``native/``.

Parity oracle: the reference repo's golden fixtures (see ``tests/golden``).
Reference behavior is cited in docstrings as ``file:line`` into the upstream
tree (e.g. ``mash/src/mash/Sketch.cpp:56``).
"""

import os

import jax

# The sketch engine hashes 64-bit lanes (MurmurHash3_x64_128 over uint64
# factor-length vectors, ref hash.cpp:45-73); uint64 arrays require x64 mode.
# This must run before any JAX arrays are created.
jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Where compiled programs persist across processes: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads it itself), else a fixed
    git-ignored ``.jax_cache`` directory in the checkout — a fixed path,
    because the path is part of the cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


# Kernel shapes are bucketed to a small fixed set (see models.sketch), so
# the persistent cache makes every process after the first start warm.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

__version__ = "0.1.0"

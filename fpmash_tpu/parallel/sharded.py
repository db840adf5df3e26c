"""Sharded pipelines: fingerprint hashing, bottom-k merge, all-pairs tiles.

Everything here is ``shard_map`` over a 1-D ``dp`` mesh:

* :func:`sharded_fingerprint_hashes` — windows shard across devices; each
  device runs the fused Duval->Murmur3 kernel locally; results all-gather.
* :func:`sharded_bottom_k` — each device computes a local bottom-k over its
  hash shard, candidates all-gather (s per device), and the final bottom-k
  reduces the gathered candidate pool.  This is exactly the reference's
  MinHashHeap semantics at slice scale: bottom-k is an associative,
  order-insensitive reduction over distinct values.
* :func:`sharded_all_pairs` — queries shard across devices; each device
  computes its [R, Q/D] tile of common/denom against the replicated
  reference sketch batch; tiles all-gather along the query axis.
* :func:`pipeline_step` — the full fused step (factorize -> hash ->
  bottom-k merge -> all-pairs distance) used by the multi-chip dry run and
  benchmarks.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fpmash_tpu.ops.compare import pairwise_common_denom
from fpmash_tpu.ops.lyndon import cfl_lengths_onehot as cfl_lengths
from fpmash_tpu.ops.murmur3 import murmur3_u64_batch
from fpmash_tpu.parallel.mesh import default_mesh

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # NumPy: no jnp work at import


def visible_device_count() -> int:
    """Devices the auto-sharding layer may use.

    ``FPMASH_DEVICES=N`` caps it (the multi-chip analog of the reference's
    ``-p`` thread knob); the CLI paths consult this so the same command
    transparently data-parallelizes over however many chips are attached.
    """
    try:
        n = jax.device_count()
    except Exception:  # pragma: no cover - no backend at all
        return 1
    cap = os.environ.get("FPMASH_DEVICES", "").strip()
    if cap:
        n = max(1, min(n, int(cap)))
    return n


def shard_rows(fn, arrays, replicated=()):
    """Run ``fn(*arrays, *replicated)`` data-parallel over the visible
    devices, sharding every ``arrays`` input and every output along its
    leading (row) axis; ``replicated`` inputs go whole to every device.

    The row inputs share a common leading dimension ``B``; it is padded up
    to a multiple of the device count (the row kernels treat zero rows as
    empty — same convention as the over-allocated batch tails), ``fn`` runs
    under ``shard_map`` on a 1-D ``dp`` mesh with no cross-device traffic,
    and the outputs are sliced back to ``B`` rows.  With one visible device
    this is exactly ``fn(*arrays, *replicated)``.  Results are bitwise
    identical to the single-device run because the computation is
    row-independent.
    """
    D = visible_device_count()
    arrays = [jnp.asarray(a) for a in arrays]
    replicated = [jnp.asarray(a) for a in replicated]
    if D <= 1:
        return fn(*arrays, *replicated)
    B = arrays[0].shape[0]
    Bp = -(-B // D) * D
    padded = []
    for a in arrays:
        if a.shape[0] != Bp:
            pad = [(0, Bp - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            a = jnp.pad(a, pad)
        padded.append(a)
    out_tree = jax.eval_shape(fn, *padded, *replicated)
    mesh = default_mesh(D)
    sm = shard_map(
        fn,
        mesh=mesh,
        in_specs=tuple(P("dp", *([None] * (a.ndim - 1))) for a in padded)
        + tuple(P() for _ in replicated),
        out_specs=jax.tree.map(
            lambda l: P("dp", *([None] * (l.ndim - 1))), out_tree
        ),
        check_vma=False,
    )
    outs = sm(*padded, *replicated)
    return jax.tree.map(lambda o: o[:B], outs)


def _fused_fingerprint_hashes(windows, lengths, seed: int):
    """Fused per-shard kernel: Duval factor lengths -> Murmur3 over the
    u64 length-vector (the fingerprint hashing unit, Sketch.cpp:132)."""
    fac_len, fac_count = cfl_lengths(windows, lengths)
    h1, _ = murmur3_u64_batch(fac_len.astype(jnp.uint64), fac_count, seed=seed)
    return h1


def sharded_fingerprint_hashes(mesh: Mesh, windows, lengths, seed: int = 42):
    """[B, L] u8 windows (B divisible by mesh size) -> u64 hashes [B],
    computed shard-local with no cross-device traffic until the caller
    gathers."""
    fn = shard_map(
        partial(_fused_fingerprint_hashes, seed=seed),
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    return fn(windows, lengths)


def _local_bottom_k(hashes, valid, s: int):
    x = jnp.where(valid, hashes, _U64MAX)
    x = jnp.sort(x)
    is_start = jnp.concatenate([jnp.array([True]), x[1:] != x[:-1]])
    is_start = is_start & (x != _U64MAX)
    # selection by pad-and-resort (see ops/bottomk._select_first_s): the
    # deduped values form the ascending prefix of the second sort
    x2 = jnp.sort(jnp.where(is_start, x, _U64MAX))
    if x2.shape[0] < s:  # tiny shards (dry-run shapes) still emit s slots
        x2 = jnp.concatenate([x2, jnp.full((s - x2.shape[0],), _U64MAX)])
    return x2[:s]


def sharded_bottom_k(mesh: Mesh, hashes, valid, s: int):
    """Global bottom-s distinct hashes of a sharded pool.

    Per-shard bottom-s -> all_gather of D*s candidates -> final bottom-s.
    Correct because the global bottom-s distinct values are each in the
    bottom-s of whichever shard holds them.
    """

    def shard_fn(h, v):
        local = _local_bottom_k(h, v, s)  # [s]
        allc = jax.lax.all_gather(local, "dp")  # [D, s]
        flat = allc.reshape(-1)
        return _local_bottom_k(flat, flat != _U64MAX, s)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=P(),  # replicated result
        check_vma=False,
    )
    return fn(hashes, valid)


from functools import lru_cache


@lru_cache(maxsize=None)
def _sharded_all_pairs_fn(mesh: Mesh, sketch_size: int):
    def shard_fn(r, rl, q, ql):
        return pairwise_common_denom(r, rl, q, ql, sketch_size=sketch_size)

    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P("dp", None), P("dp")),
            out_specs=(P(None, "dp"), P(None, "dp")),
            check_vma=False,
        )
    )


def sharded_all_pairs(mesh: Mesh, ref, ref_len, qry, qry_len, sketch_size: int):
    """common/denom for all (ref, query) pairs with queries sharded.

    ``ref[R, S]`` is replicated; ``qry[Q, S]`` shards over dp; each device
    computes its [R, Q/D] tile; output shards along the query axis.  The
    jitted shard_map is cached per (mesh, sketch_size) so tile loops reuse
    one executable.
    """
    return _sharded_all_pairs_fn(mesh, sketch_size)(ref, ref_len, qry, qry_len)


@lru_cache(maxsize=None)
def _sharded_all_pairs_walk_fn(mesh: Mesh, sketch_size: int):
    from fpmash_tpu.ops.walk import pairwise_walk_common_denom

    def shard_fn(r, rl, q, ql):
        return pairwise_walk_common_denom(r, rl, q, ql, sketch_size=sketch_size)

    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P("dp", None), P("dp")),
            out_specs=(P(None, "dp"), P(None, "dp")),
            check_vma=False,
        )
    )


def sharded_all_pairs_walk(mesh: Mesh, ref, ref_len, qry, qry_len,
                           sketch_size: int):
    """Order-dependent walk (unsorted fingerprint lists) with queries
    sharded over dp — same layout as :func:`sharded_all_pairs`."""
    return _sharded_all_pairs_walk_fn(mesh, sketch_size)(
        ref, ref_len, qry, qry_len
    )


@lru_cache(maxsize=None)
def _sharded_positional_fn(mesh: Mesh):
    def shard_fn(rows, row_lens, table, table_lens):
        # rows [N/D, S] shard; table [N, S] replicated; per-device tile
        # [N/D, N] of positional matches (same math as
        # ops.compare.pairwise_positional's inner fn)
        def one(a, la):
            n = jnp.minimum(la, table_lens)  # [N]
            idx = jnp.arange(table.shape[-1], dtype=jnp.int32)
            eq = (a[None, :] == table) & (idx[None, :] < n[:, None])
            return jnp.sum(eq.astype(jnp.int32), axis=-1), n

        return jax.vmap(one)(rows, row_lens)

    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("dp", None), P("dp"), P(), P()),
            out_specs=(P("dp", None), P("dp", None)),
            check_vma=False,
        )
    )


def sharded_all_pairs_positional(mesh: Mesh, hashes, lens):
    """All-pairs positional fingerprint matches with the row axis sharded
    (the `triangle -fp` comparison, CommandTriangle.cpp:265): each device
    owns N/D rows and compares them against the replicated table."""
    D = mesh.devices.size
    N = hashes.shape[0]
    Np = -(-N // D) * D
    h = jnp.asarray(hashes)
    l = jnp.asarray(lens)
    hp = jnp.pad(h, ((0, Np - N), (0, 0))) if Np != N else h
    lp = jnp.pad(l, (0, Np - N)) if Np != N else l
    m, n = _sharded_positional_fn(mesh)(hp, lp, h, l)
    return m[:N], n[:N]


def pipeline_step(mesh: Mesh, windows, lengths, ref, ref_len, *, seed: int = 42,
                  sketch_size: int = 8):
    """The full training-equivalent step, jitted over the mesh:

    windows --dp--> Duval -> Murmur3 -> global bottom-k (collective merge)
    and the resulting sketch compared against a replicated reference batch
    (all-pairs tile).  Returns (sketch_values, common, denom).
    """
    hashes = sharded_fingerprint_hashes(mesh, windows, lengths, seed)
    valid = jnp.ones(hashes.shape, bool)
    sketch = sharded_bottom_k(mesh, hashes, valid, sketch_size)

    qry = sketch[None, :]  # [1, s] as a query batch
    qry_len = jnp.sum(sketch != _U64MAX, dtype=jnp.int32)[None]
    common, denom = sharded_all_pairs_replicated(mesh, ref, ref_len, qry, qry_len, sketch_size)
    return sketch, common, denom


def sharded_all_pairs_replicated(mesh: Mesh, ref, ref_len, qry, qry_len, sketch_size: int):
    """All-pairs where refs shard over dp and queries are replicated —
    the layout used when the query side is a single merged sketch."""

    def shard_fn(r, rl, q, ql):
        return pairwise_common_denom(r, rl, q, ql, sketch_size=sketch_size)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P(), P()),
        out_specs=(P("dp", None), P("dp")),
        check_vma=False,
    )
    return fn(ref, ref_len, qry, qry_len)

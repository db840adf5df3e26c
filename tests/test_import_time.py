"""Import-time hygiene: no module does jnp work when imported, and the
package places JAX's persistent compile cache where it should.

A ``jnp`` constant built while a trace is active becomes a tracer of that
trace.  A module first imported inside a ``jit`` (lazy imports in traced
code do this) would keep a leaked tracer as a module constant and break
every later trace that touches it — ``shard_map`` reports it as
"Shouldn't have any non-shard_map tracers".
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

PKG = pathlib.Path(__file__).resolve().parent.parent / "fpmash_tpu"
REPO = PKG.parent

#: modules whose constants used to be jnp scalars
LEAK_MODULES = [
    "fpmash_tpu.ops.icfl",
    "fpmash_tpu.ops.murmur3",
    "fpmash_tpu.ops.bottomk",
    "fpmash_tpu.ops.compare",
    "fpmash_tpu.parallel.sharded",
]

#: every module of the package, from the file tree (deterministic)
ALL_MODULES = sorted(
    "fpmash_tpu." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name not in ("__init__.py", "__main__.py")
)


def _tracer_globals(mod):
    return [k for k, v in vars(mod).items() if isinstance(v, jax.core.Tracer)]


def _icfl_comb_sketch(reads):
    from fpmash_tpu.models.sketch import Sketch, SketchParams

    sk = Sketch(SketchParams().for_fingerprint())
    sk.init_from_reads_fingerprint(reads, "ICFL_COMB")
    return [r.hashes for r in sk.references]


@pytest.mark.parametrize("name", LEAK_MODULES)
def test_reimport_under_trace_leaks_no_tracer(name, monkeypatch):
    """Re-import the module inside a jit trace; its constants must not be
    tracers, and the ICFL_COMB device path must then still run under
    shard_map in the same process."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mod = importlib.import_module(name)

    def reimport(x):
        importlib.reload(mod)
        return x

    jax.jit(reimport)(1)
    assert _tracer_globals(mod) == []

    rng = np.random.default_rng(3)
    reads = [
        (f"r{i}", "".join("ACGT"[c] for c in rng.integers(0, 4, size=130)))
        for i in range(3)
    ]  # 390 shift windows: the device path
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    sharded = _icfl_comb_sketch(reads)
    monkeypatch.setenv("FPMASH_DEVICES", "1")
    single = _icfl_comb_sketch(reads)
    assert all(np.array_equal(a, b) for a, b in zip(sharded, single))


_IMPORT_PROBE = """
import importlib, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as the package sets it
names = sys.argv[1:]

def imports(x):
    for n in names:
        importlib.import_module(n)
    return x

jax.jit(imports)(1)
print(json.dumps({
    n: [k for k, v in vars(sys.modules[n]).items()
        if isinstance(v, jax.core.Tracer)]
    for n in names
}))
"""


def _subprocess_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    # like conftest: no persistent cache files in the checkout
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def first_import_under_trace():
    """Import every module for the first time inside one jit trace (in a
    fresh interpreter) and report each module's tracer-valued globals."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE, *ALL_MODULES],
        capture_output=True, text=True, env=_subprocess_env(), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ALL_MODULES)
def test_module_does_no_jnp_work_at_import(name, first_import_under_trace):
    assert first_import_under_trace[name] == []


_CACHE_PROBE = """
import jax, fpmash_tpu
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_dir_in_fresh_process(**extra):
    env = _subprocess_env(**extra)
    if "JAX_COMPILATION_CACHE_DIR" not in extra:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_ignored_dir_in_checkout():
    want = str(REPO / ".jax_cache")
    assert _cache_dir_in_fresh_process() == want
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_follows_environment(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(JAX_COMPILATION_CACHE_DIR=d) == d

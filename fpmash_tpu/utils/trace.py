"""Lightweight stage tracing — the observability layer the reference lacks
(SURVEY §5: only ad-hoc cerr progress prints).

Enable with ``FPMASH_TRACE=1``: every traced stage prints
``[fpmash] <stage>: <seconds>s  <extra>`` to stderr.  Zero overhead when
disabled.  Usable as a context manager or decorator.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_ENABLED = bool(os.environ.get("FPMASH_TRACE"))


def enabled() -> bool:
    return _ENABLED


@contextmanager
def trace(stage: str, **extra):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        info = "  ".join(f"{k}={v}" for k, v in extra.items())
        print(f"[fpmash] {stage}: {dt:.3f}s  {info}".rstrip(), file=sys.stderr)


def log(msg: str) -> None:
    if _ENABLED:
        print(f"[fpmash] {msg}", file=sys.stderr)

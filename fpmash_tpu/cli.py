"""`fpmash` — the unified CLI.

Mirrors both reference entry points: the Mash command set (mash.cpp:21-39:
sketch, dist, triangle, screen, taxscreen, contain, paste, info, bounds,
find) and the lyn2vec verbs (generate, fingerprint, mapping;
lyn2vec.py:241-287).  Run ``python -m fpmash_tpu <command> ...`` or install
the ``fpmash`` script.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fpmash",
        description="fpmash — accelerated Lyndon-fingerprint MinHash sketching and distance estimation.",
    )
    sub = parser.add_subparsers(dest="command", metavar="<command>")

    from fpmash_tpu.commands import (
        bounds_cmd,
        contain_cmd,
        dist_cmd,
        find_cmd,
        info_cmd,
        lyn2vec_cmd,
        paste_cmd,
        screen_cmd,
        sketch_cmd,
        taxscreen_cmd,
        triangle_cmd,
    )

    sketch_cmd.add_parser(sub)
    dist_cmd.add_parser(sub)
    triangle_cmd.add_parser(sub)
    screen_cmd.add_parser(sub)
    taxscreen_cmd.add_parser(sub)
    contain_cmd.add_parser(sub)
    paste_cmd.add_parser(sub)
    info_cmd.add_parser(sub)
    bounds_cmd.add_parser(sub)
    find_cmd.add_parser(sub)
    lyn2vec_cmd.add_parsers(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # mash-style single-dash long flags: map "-fp" style tokens before parse
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 0
    from fpmash_tpu.utils.trace import trace

    with trace(f"command:{args.command}"):
        return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""CLI driver (reference /root/reference/src/main.zig:37-117).

Same orchestration: banner → -h/-v pre-scan → parse → load → (search |
fixed-q bypass) → write, with the same human progress lines on stderr so
measure.py-style harnesses can scrape pass counts (reference
scripts/measure.py:22-28 greps stderr for "N passes").
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from . import __version__
from .backend import EncBuffer, EncCtx, get_backend
from .io.image import load_image, to_rgb8
from .options import OptionError, parse_args, usage_text
from .runtime import enable_compile_cache


def _perr(msg: str) -> None:
    print(msg, file=sys.stderr)


def _print_version() -> None:
    _perr(f"oavif-jax {__version__}")
    try:
        import jax

        _perr(f"jax {jax.__version__} [{jax.default_backend()}]")
    except Exception:
        _perr("jax unavailable")
    try:
        from PIL import _avif, __version__ as pilver

        _perr(f"pillow {pilver} (oracle: {_avif.codec_versions()})")
    except Exception:
        pass


def run(argv: List[str]) -> int:
    _perr(f"\x1b[31moavif-jax\x1b[0m | {__version__}")

    # argv pre-scan for -h/-v (main.zig:51-62)
    for arg in argv:
        if arg in ("--help", "-h"):
            _perr(usage_text())
            return 0
        if arg in ("--version", "-v"):
            _print_version()
            return 0
        break

    try:
        parsed = parse_args(argv)
    except OptionError:
        return 1
    o = parsed.options

    if parsed.input_file is None or parsed.output_file is None:
        _perr("Error: missing input or output path")
        return 1

    try:
        src = load_image(parsed.input_file)
    except (OSError, ValueError) as e:
        _perr(f"Error: {e}")
        return 1

    in_depth = 16 if src.hbd else 8
    in_bytes = os.path.getsize(parsed.input_file)
    _perr(
        f"Read {src.width}x{src.height}, "
        f"{'RGBA' if src.channels > 3 else 'RGB'}, {in_depth}-bit, {in_bytes} bytes"
    )

    # the planner and metric compile once per shape; the persistent cache
    # lets repeated runs on one machine pay that once
    enable_compile_cache()
    rgb = to_rgb8(src)
    ctx = EncCtx(o=o, src=src, rgb=rgb, w=src.width, h=src.height)

    backend_name = os.environ.get("OAVIF_BACKEND", "oavif")
    backend = get_backend(backend_name)

    out_depth = 10 if o.tenbit else (10 if src.hbd else 8)

    if o.quality is not None:  # bypass TQ (main.zig:93-100)
        ctx.q = o.quality
        _perr(f"Encoding [q{o.quality}, speed {o.speed}, {out_depth}-bit]")
        data = backend.encode(ctx)
        with open(parsed.output_file, "wb") as f:
            f.write(data)
        ctx.buf = EncBuffer(q=ctx.q, data=data, size=len(data))
        bpp = len(data) * 8 / (ctx.w * ctx.h)
        _perr(f"Compressed to {len(data)} bytes ({bpp:.3f} bpp)")
        return 0

    from .tq.driver import search_encode

    _perr(
        f"Searching [tgt {o.score_tgt:g}±{o.tolerance:.1f}, "
        f"speed {o.speed}, {out_depth}-bit]"
    )
    # Observability (SURVEY.md §5): OAVIF_TRACE=<dir> captures a
    # jax.profiler trace of the search; per-pass wall timings print with
    # OAVIF_VERBOSE=1.
    trace_dir = os.environ.get("OAVIF_TRACE")
    if trace_dir:
        import jax

        jax.profiler.start_trace(trace_dir)
    try:
        result, data = search_encode(ctx, backend)
    finally:
        if trace_dir:
            import jax

            jax.profiler.stop_trace()
            _perr(f"Profiler trace written to {trace_dir}")
    if os.environ.get("OAVIF_VERBOSE") == "1":
        _perr(f"Pass timings (ms): {search_encode.last_timings}")
    rounds = ""
    if 0 < ctx.num_rounds < ctx.num_pass:
        # batched speculative mode: several encodes share one scoring
        # round; report both (passes == encodes, reference semantics)
        rounds = f" in {ctx.num_rounds} rounds"
    _perr(
        f"Found q{result.q} (score {result.score:.2f}, "
        f"{ctx.num_pass} passes{rounds})"
    )

    with open(parsed.output_file, "wb") as f:
        f.write(data)
    bpp = len(data) * 8 / (ctx.w * ctx.h)
    _perr(f"Compressed to {len(data)} bytes ({bpp:.3f} bpp)")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()

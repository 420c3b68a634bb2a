"""libavif/libaom oracle backend.

This wraps the exact native stack the reference delegates to
(/root/reference/src/io.zig:544-636 encode; :638-666 decode) through
Pillow's bundled libavif (aom encoder, dav1d decoder). It exists for three
purposes only:

  1. Conformance oracle — every bitstream our encoder emits must decode
     through this independent AV1 decoder to the encoder's own
     reconstruction (SURVEY.md §4).
  2. Baseline — reproduces the reference binary's behavior for
     measure.py-style comparison runs (BASELINE.md).
  3. Stand-in for features our encoder lacks (SURVEY.md §7 build order
     step 2).

It is NOT the product encode path.
"""

from __future__ import annotations

import io as _stdio

import numpy as np

from . import EncCtx
from ..io.image import decode_avif_to_rgb8


class OracleBackend:
    name = "oracle"

    def encode(self, ctx: EncCtx) -> bytes:
        from PIL import Image as PILImage

        o = ctx.o
        src = ctx.src
        d = src.data
        # Pillow's encoder takes 8-bit RGB(A); mirror the reference's
        # depth-conversion (io.zig:595-606: 16→8 via >>8). The tenbit path
        # (io.zig:566-594) is approximated at 8-bit here; the product
        # backend implements true 10-bit.
        if src.hbd:
            d = (d >> 8).astype(np.uint8)
        if src.channels == 4:
            im = PILImage.fromarray(d, mode="RGBA")
        elif src.channels == 3:
            im = PILImage.fromarray(d, mode="RGB")
        else:
            g = d[..., 0] if d.ndim == 3 else d
            im = PILImage.fromarray(np.repeat(g[..., None], 3, -1), mode="RGB")

        advanced = {"tune": o.tune.value}
        buf = _stdio.BytesIO()
        kwargs = dict(
            quality=int(ctx.q),
            speed=int(o.speed),
            subsampling="4:4:4",  # io.zig:548 AVIF_PIXEL_FORMAT_YUV444
            max_threads=int(o.max_threads),
            range="full",
            tile_rows=int(o.tile_rows_log2),
            tile_cols=int(o.tile_cols_log2),
            autotiling=bool(o.auto_tiling),
            advanced=advanced,
        )
        if src.icc:
            kwargs["icc_profile"] = src.icc
        try:
            im.save(buf, format="AVIF", **kwargs)
        except ValueError:
            # Older bundled aom may not know a given tune — drop it.
            kwargs.pop("advanced", None)
            buf = _stdio.BytesIO()
            im.save(buf, format="AVIF", **kwargs)
        return buf.getvalue()

    def decode_to_rgb8(self, data: bytes) -> np.ndarray:
        return decode_avif_to_rgb8(data)

"""The product encode path.

Division of labor (SURVEY.md §2b/§7):
  - DEVICE (one batched JAX step per probe, planes device-resident across
    the TQ search): the frame's full partition + intra-mode search — all
    blocks × all modes predicted and SSD-scored at the 64/32/16 grids,
    partition decisions, packed-plan download (oavif_jax.av1.device_plan).
    The corpus pipeline also scores probes on the device
    (oavif_jax.tq.pipeline).
  - HOST (C runtime, GIL-released per tile): the entropy-inherent serial
    work — exact integer prediction/transform/RDOQ under the device plan,
    adaptive symbol coding, reconstruction, deblock/CDEF, ISOBMFF muxing,
    and the CLI search's SSIMULACRA2 scoring (metric/ssimu2.c).
Set OAVIF_DEVICE_PLANNER=0 to search on the host only.
"""

from __future__ import annotations

import numpy as np

from . import EncCtx
from ..io.image import decode_avif_to_rgb8


class OavifBackend:
    name = "oavif"

    def encode(self, ctx: EncCtx) -> bytes:
        from ..av1.encode import encode_avif

        return encode_avif(ctx)

    def encode_with_recon(self, ctx: EncCtx):
        """Encode and return (bytes, recon RGB8). The recon equals the
        decoder's output (bit-exact YUV), so the TQ loop scores it directly
        without a decode round-trip (SURVEY.md §2b N3)."""
        from ..av1.encode import encode_avif_with_recon

        return encode_avif_with_recon(ctx)

    def decode_to_rgb8(self, data: bytes) -> np.ndarray:
        # Scoring decode: the conformance-oracle decoder (independent AV1
        # implementation). The in-loop TQ path instead uses the encoder's
        # own reconstruction and never round-trips bytes.
        return decode_avif_to_rgb8(data)

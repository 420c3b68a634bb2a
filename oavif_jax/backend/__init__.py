"""Encoder backends.

A backend turns (image, options, quantizer) into AVIF bytes and can decode
AVIF bytes back to RGB8 for scoring. Two implementations:

  - ``oavif_jax.backend.oavif``  — the product: the device-planned AV1
    encoder.
  - ``oavif_jax.backend.oracle`` — libavif/libaom via Pillow. Used ONLY as
    the conformance oracle (independent AV1 decode of our bitstreams), as
    the behavior/performance baseline (it is exactly what the reference
    binary wraps, /root/reference/src/io.zig:544-636), and as a stand-in
    for features our encoder lacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

import numpy as np

from ..options import EncOptions
from ..io.image import Image


@dataclass
class EncBuffer:
    """Cached last-encoded bitstream (reference main.zig:11-23)."""

    q: Optional[int] = None
    data: Optional[bytes] = None
    size: int = 0


@dataclass
class EncCtx:
    """Encoder context shared by the CLI, TQ loop, and backends
    (reference main.zig:26-35)."""

    o: EncOptions
    src: Image
    rgb: np.ndarray  # 8-bit RGB metric reference, (h, w, 3)
    w: int
    h: int
    q: int = 0
    num_pass: int = 0       # encodes performed (reference pass semantics)
    num_rounds: int = 0     # batched mode: scoring rounds (<= num_pass)
    score: float = 0.0
    buf: EncBuffer = field(default_factory=EncBuffer)


class EncoderBackend(Protocol):
    name: str

    def encode(self, ctx: EncCtx) -> bytes:
        """Encode ctx.src at quantizer ctx.q per ctx.o → AVIF bytes."""
        ...

    def decode_to_rgb8(self, data: bytes) -> np.ndarray:
        """Decode AVIF bytes to (h, w, 3) uint8 (alpha dropped)."""
        ...


MetricFn = Callable[[np.ndarray, np.ndarray], float]


def get_backend(name: str) -> EncoderBackend:
    if name == "oracle":
        from .oracle import OracleBackend

        return OracleBackend()
    if name == "oavif":
        from .oavif import OavifBackend

        return OavifBackend()
    raise ValueError(f"unknown backend {name!r}")

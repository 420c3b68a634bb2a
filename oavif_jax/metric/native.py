"""Host-native SSIMULACRA2 (ssimu2.c) with a reference-context cache.

Two interchangeable implementations exist (both from scratch):

  - the JAX one (ssimulacra2.py) — the device path, vmappable over
    candidate batches, used by the corpus pipeline, the multi-device
    dryrun and wide probe batches (SURVEY.md §2b N4);
  - this C one — identical math (same FIR Gaussian, same weights, same
    scale rule) on the host, built into the same shared library as the
    tile encoder.

Why both: a device metric call pays a recon upload and a scalar readback
per probe, while the C path needs no transfer; which is cheaper per probe
on the GPU host is not measured yet. tests/test_metric.py asserts the two
implementations agree within epsilon on every fixture, so either can
score a search; OAVIF_METRIC=jax|c|auto selects (auto = C when the native
library is available, else JAX).
"""

from __future__ import annotations

import ctypes as C
import os
import zlib
from typing import Optional

import numpy as np

from ..av1.entropy.fast import get_lib


def available() -> bool:
    return get_lib() is not None


class _RefCtx:
    """Owns one ssimu2 reference context (pyramid + ref statistics)."""

    def __init__(self, ref_rgb8: np.ndarray) -> None:
        self.lib = get_lib()
        a = np.ascontiguousarray(ref_rgb8, dtype=np.uint8)
        h, w = a.shape[:2]
        self.h, self.w = h, w
        self._ctx = self.lib.ssimu2_ref_new(
            a.ctypes.data_as(C.POINTER(C.c_uint8)), w, h
        )

    def score(self, dist_rgb8: np.ndarray) -> float:
        d = np.ascontiguousarray(dist_rgb8, dtype=np.uint8)
        assert d.shape[:2] == (self.h, self.w)
        return float(
            self.lib.ssimu2_score(self._ctx, d.ctypes.data_as(C.POINTER(C.c_uint8)))
        )

    def __del__(self) -> None:
        try:
            if self._ctx:
                self.lib.ssimu2_ref_free(self._ctx)
                self._ctx = None
        except Exception:
            pass


# LRU of reference contexts keyed by a full-content digest (crc32 of the
# bytes — cheap at <1 ms for 512^2 and collision-safe in practice; the
# TQ loop scores many probes against one reference).
_CTX_CACHE: dict = {}
_CTX_ORDER: list = []
_CTX_MAX = 4


def _get_ctx(ref_rgb8: np.ndarray) -> _RefCtx:
    a = np.ascontiguousarray(ref_rgb8, dtype=np.uint8)
    key = (a.shape, zlib.crc32(a.tobytes()))
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        while len(_CTX_ORDER) >= _CTX_MAX:
            old = _CTX_ORDER.pop(0)
            _CTX_CACHE.pop(old, None)
        ctx = _RefCtx(a)
        _CTX_CACHE[key] = ctx
        _CTX_ORDER.append(key)
    else:
        _CTX_ORDER.remove(key)
        _CTX_ORDER.append(key)
    return ctx


def compute_ssimulacra2_native(ref_rgb8, dist_rgb8) -> Optional[float]:
    """Score two (H, W, 3) uint8 RGB images natively; None if the library
    is unavailable. Ref-side statistics are cached across calls."""
    if get_lib() is None:
        return None
    if ref_rgb8.shape != dist_rgb8.shape:
        raise ValueError(f"shape mismatch {ref_rgb8.shape} vs {dist_rgb8.shape}")
    if ref_rgb8.shape[0] < 8 or ref_rgb8.shape[1] < 8:
        raise ValueError("SSIMULACRA2 requires images at least 8x8")
    return _get_ctx(ref_rgb8).score(dist_rgb8)


def metric_impl() -> str:
    """Selected implementation: 'c' or 'jax' (OAVIF_METRIC=c|jax|auto)."""
    mode = os.environ.get("OAVIF_METRIC", "auto").lower()
    if mode == "jax":
        return "jax"
    if mode == "c":
        return "c"
    return "c" if available() else "jax"


def score_batch_auto(ref_rgb8, dist_batch) -> np.ndarray:
    """Score a (N, H, W, 3) batch against one reference with the selected
    implementation (native loop or one vmapped device step)."""
    if metric_impl() == "c":
        ctx = _get_ctx(ref_rgb8)
        return np.array([ctx.score(d) for d in dist_batch], dtype=np.float64)
    from .ssimulacra2 import compute_ssimulacra2_batch

    return compute_ssimulacra2_batch(ref_rgb8, dist_batch)

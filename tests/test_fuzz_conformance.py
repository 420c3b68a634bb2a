"""Randomized conformance soak: the full tool matrix against dav1d.

Every round-4 tool (rect partitions, palette, filter-intra, loop
restoration, 128px superblocks, IDTX, chroma delta-q, 8/10-bit) can
interact; this test drives randomized content x config combinations
through the PRODUCT frame encoder and asserts the decode==recon
invariant each time. Seeded (deterministic in CI); a couple dozen
combinations per run keeps it under half a minute while covering the
pairwise space over time.
"""

from __future__ import annotations

import numpy as np
import pytest


def _content(rng, kind, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == 0:  # smooth + noise
        g = 128 + 70 * np.sin(xx / 23) * np.cos(yy / 17)
        img = np.stack([g, 0.8 * g + 20, 230 - 0.6 * g], -1)
        img += rng.normal(0, 6, img.shape)
    elif kind == 1:  # hard edges / flat regions (palette + sb128 bait)
        img = np.full((h, w, 3), 90.0)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            hh, ww = rng.integers(8, h - y0 + 1), rng.integers(8, w - x0 + 1)
            img[y0 : y0 + hh, x0 : x0 + ww] = rng.integers(0, 256, 3)
    elif kind == 2:  # oriented stripes (rect/directional bait)
        ang = rng.uniform(0.2, 1.4)
        g = 128 + 90 * np.sin((xx * np.cos(ang) + yy * np.sin(ang)) / 6)
        img = np.stack([g, g, g], -1) + rng.normal(0, 4, (h, w, 3))
    elif kind == 3:  # dense noise (coefficient stress)
        img = rng.uniform(0, 255, (h, w, 3))
    else:  # text-on-gradient (LOSSY palette bait under 10-bit depth
        # conversion: >8 distinct values per block, still screen-shaped)
        img = np.stack([200 + 40 * yy / h, 210 + 30 * yy / h,
                        225 + 20 * yy / h], -1)
        for _ in range(max(8, h * w // 900)):
            x0, y0 = rng.integers(2, w - 9), rng.integers(2, h - 12)
            glyph = rng.random((10, 7)) > 0.5
            col = float(rng.integers(0, 70))
            for c in range(3):
                ch = img[y0 : y0 + 10, x0 : x0 + 7, c]
                ch[glyph] = col
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(autouse=True)
def _restore_idtx_env():
    """--tune ssim exports OAVIF_IDTX for the mirrored coders; keep the
    fuzz cases from leaking it into each other or later tests."""
    import os

    saved = os.environ.get("OAVIF_IDTX")
    yield
    if saved is None:
        os.environ.pop("OAVIF_IDTX", None)
    else:
        os.environ["OAVIF_IDTX"] = saved


@pytest.mark.parametrize("case", range(20))
def test_fuzz_product_decode_equals_recon(case):
    import types as pytypes

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.av1.yuv import yuv444_to_rgb
    from oavif_jax.io.avif_ctypes import decode_to_yuv
    from oavif_jax.options import EncOptions, TuneMode

    rng = np.random.default_rng(1000 + case)
    h = int(rng.choice([96, 128, 152, 200, 256]))
    w = int(rng.choice([96, 136, 192, 256]))
    kind = case % 5
    img = _content(rng, kind, h, w)
    o = EncOptions()
    o.speed = int(rng.choice([4, 6, 8, 9, 10]))
    o.tenbit = int(rng.choice([0, 1]))
    if rng.random() < 0.3:
        o.tune = TuneMode.SSIM
    if rng.random() < 0.25:  # tile grid x toolset interactions
        o.tile_cols_log2 = int(rng.choice([1, 2]))
        o.tile_rows_log2 = int(rng.choice([0, 1]))
    q = int(rng.choice([25, 45, 65, 85, 95]))
    src = pytypes.SimpleNamespace(data=img, channels=3, hbd=False, icc=None)
    ctx = pytypes.SimpleNamespace(o=o, src=src, q=q)
    data, recon = encode_avif_with_recon(ctx)
    yuv, depth, _ = decode_to_yuv(data)
    dec_rgb = yuv444_to_rgb([p for p in yuv], bitdepth=depth)
    np.testing.assert_array_equal(
        dec_rgb, recon,
        err_msg=f"case {case}: {h}x{w} kind{kind} speed{o.speed} "
                f"tenbit{o.tenbit} q{q} tune{o.tune}",
    )

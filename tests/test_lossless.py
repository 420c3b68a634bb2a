"""CodedLossless (qindex 0) conformance: WHT 4x4, recon == source exactly
(BASELINE config 3: --quality-alpha 100 lossless alpha)."""

import io as iomod

import numpy as np
import pytest
from PIL import Image as PILImage

from oavif_jax.av1.encode import encode_avif_with_recon
from oavif_jax.av1.transform import fwd_wht4x4, inv_wht4x4
from oavif_jax.av1.yuv import rgb_to_yuv444
from oavif_jax.backend import EncCtx
from oavif_jax.io.avif_ctypes import decode_to_yuv
from oavif_jax.io.image import Image
from oavif_jax.options import EncOptions


def test_wht_roundtrip_exact(rng):
    for _ in range(500):
        x = rng.integers(-1023, 1024, (4, 4))
        np.testing.assert_array_equal(inv_wht4x4(fwd_wht4x4(x)), x)


@pytest.mark.parametrize("shape", [(16, 16), (64, 64), (48, 80)])
def test_lossless_color_yuv_exact(rng, shape):
    img = np.clip(rng.normal(128, 40, shape + (3,)), 0, 255).astype(np.uint8)
    h, w = shape
    src = Image(width=w, height=h, channels=3, hbd=False, data=img)
    ctx = EncCtx(o=EncOptions(tenbit=False), src=src, rgb=img, w=w, h=h, q=100)
    data, recon = encode_avif_with_recon(ctx)
    planes, depth, _ = decode_to_yuv(data)
    ours = rgb_to_yuv444(img, bitdepth=8)
    for a, b in zip(planes, ours):
        np.testing.assert_array_equal(a, b)


def test_lossless_alpha_plane_exact(rng):
    """--quality-alpha 100: the alpha plane survives bit-exactly (it
    bypasses YUV conversion entirely)."""
    h, w = 32, 48
    rgba = np.clip(rng.normal(128, 40, (h, w, 4)), 0, 255).astype(np.uint8)
    src = Image(width=w, height=h, channels=4, hbd=False, data=rgba)
    ctx = EncCtx(
        o=EncOptions(tenbit=False, quality_alpha=100),
        src=src, rgb=rgba[..., :3], w=w, h=h, q=60,
    )
    data, _ = encode_avif_with_recon(ctx)
    im = PILImage.open(iomod.BytesIO(data))
    im.load()
    dec = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(dec[..., 3], rgba[..., 3])

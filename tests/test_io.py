"""Host image-ingestion tests (reference io.zig:42-542 behaviors)."""

import numpy as np
import pytest
from PIL import Image as PILImage

from oavif_jax.io.image import (
    Image,
    decode_avif_to_rgb8,
    load_image,
    to_rgb8,
)


def _save_png(tmp_path, arr, name="t.png", **kw):
    p = tmp_path / name
    PILImage.fromarray(arr).save(p, **kw)
    return str(p)


def test_load_png_rgb8(tmp_path, test_rgb8):
    p = _save_png(tmp_path, test_rgb8)
    img = load_image(p)
    assert (img.width, img.height, img.channels, img.hbd) == (128, 96, 3, False)
    assert np.array_equal(img.data, test_rgb8)


def test_load_png_rgba8(tmp_path, test_rgb8):
    rgba = np.dstack([test_rgb8, np.full(test_rgb8.shape[:2], 200, np.uint8)])
    p = _save_png(tmp_path, rgba, "t_rgba.png")
    img = load_image(p)
    assert img.channels == 4
    assert np.array_equal(img.data, rgba)


def test_load_png_gray_becomes_rgba(tmp_path, test_rgb8):
    # Reference spng path maps gray to RGBA8 (io.zig:276).
    gray = test_rgb8[..., 0]
    p = _save_png(tmp_path, gray, "t_gray.png")
    img = load_image(p)
    assert img.channels == 4
    assert np.array_equal(img.data[..., 0], gray)
    assert np.all(img.data[..., 3] == 255)


def test_load_png16(tmp_path):
    # Build a 16-bit RGB PNG by hand via PIL 'I;16' is gray-only, so write
    # our own PNG bytes with zlib.
    import struct
    import zlib

    h, w = 24, 32
    rng = np.random.default_rng(7)
    px = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
    raw = bytearray()
    be = px.astype(">u2").tobytes()
    stride = w * 6
    for y in range(h):
        raw.append(0)
        raw.extend(be[y * stride : (y + 1) * stride])

    def chunk(typ, payload):
        out = struct.pack(">I", len(payload)) + typ + payload
        return out + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(bytes(raw)))
    png += chunk(b"IEND", b"")
    p = tmp_path / "t16.png"
    p.write_bytes(png)

    img = load_image(str(p))
    assert img.hbd and img.channels == 4
    assert img.data.dtype == np.uint16
    assert np.array_equal(img.data[..., :3], px)
    assert np.all(img.data[..., 3] == 65535)

    # to_rgb8: 16-bit shifts down by 8 (io.zig:67-69)
    rgb8 = to_rgb8(img)
    assert np.array_equal(rgb8, (px >> 8).astype(np.uint8))


def test_load_pam_rgb(tmp_path, test_rgb8):
    h, w = test_rgb8.shape[:2]
    hdr = (
        f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
        f"TUPLTYPE RGB\nENDHDR\n"
    ).encode()
    p = tmp_path / "t.pam"
    p.write_bytes(hdr + test_rgb8.tobytes())
    img = load_image(str(p))
    assert (img.width, img.height, img.channels) == (w, h, 3)
    assert np.array_equal(img.data, test_rgb8)


def test_load_pam_rejects_bad_maxval(tmp_path):
    p = tmp_path / "bad.pam"
    p.write_bytes(b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 3\nMAXVAL 65535\nTUPLTYPE RGB\nENDHDR\n" + b"\x00" * 12)
    with pytest.raises(ValueError):
        load_image(str(p))


def test_load_jpeg_gray_stays_single_channel(tmp_path, test_rgb8):
    p = tmp_path / "t.jpg"
    PILImage.fromarray(test_rgb8[..., 0]).save(p, quality=90)
    img = load_image(str(p))
    assert img.channels == 1  # io.zig:196-197 JCS_GRAYSCALE


def test_load_webp(tmp_path, test_rgb8):
    p = tmp_path / "t.webp"
    PILImage.fromarray(test_rgb8).save(p, lossless=True)
    img = load_image(str(p))
    assert img.channels == 3
    assert np.array_equal(img.data, test_rgb8)


def test_to_rgb8_drops_alpha_and_expands_gray():
    rgba = np.zeros((4, 4, 4), np.uint8)
    rgba[..., 0] = 10
    rgba[..., 3] = 99
    out = to_rgb8(Image(4, 4, 4, False, rgba))
    assert out.shape == (4, 4, 3) and out[..., 0].max() == 10

    gray = np.full((4, 4, 1), 42, np.uint8)
    out = to_rgb8(Image(4, 4, 1, False, gray))
    assert out.shape == (4, 4, 3) and np.all(out == 42)


def test_avif_roundtrip_via_oracle(tmp_path, test_rgb8):
    import io as stdio

    buf = stdio.BytesIO()
    PILImage.fromarray(test_rgb8).save(buf, format="AVIF", quality=85, speed=10)
    rgb = decode_avif_to_rgb8(buf.getvalue())
    assert rgb.shape == test_rgb8.shape
    # lossy but close
    assert np.mean(np.abs(rgb.astype(int) - test_rgb8.astype(int))) < 12


def test_native_yuv_conversions_match_numpy():
    """The C one-pass YUV<->RGB fast paths agree with the numpy reference
    (exactly on the inverse; within 1 LSB on the forward — float rounding
    order, encoder input freedom)."""
    import numpy as np

    import oavif_jax.av1.entropy.fast as fast
    from oavif_jax.av1 import yuv as yuv_mod

    if fast.get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    for bd, dt in ((8, np.uint8), (10, np.uint16)):
        maxv = (1 << bd) - 1
        rgb = rng.integers(0, maxv + 1, (96, 130, 3)).astype(dt)
        nat = yuv_mod.rgb_to_yuv444(rgb, bd)
        flat = rgb.reshape(-1, 3).astype(np.float32)
        ref = flat @ yuv_mod._FWD
        ref[:, 1:] += np.float32((maxv + 1) / 2)
        ref = np.clip(np.floor(ref + 0.5), 0, maxv).astype(np.int64)
        for i in range(3):
            d = np.abs(np.asarray(nat[i], np.int64).reshape(-1) - ref[:, i])
            assert d.max() <= 1
        planes = [rng.integers(0, maxv + 1, (96, 130)).astype(np.int32)
                  for _ in range(3)]
        nat2 = yuv_mod.yuv444_to_rgb(planes, bd)
        y2 = np.stack([p.reshape(-1) for p in planes], 1).astype(np.float32)
        y2[:, 1:] -= np.float32((maxv + 1) / 2)
        out = np.clip(np.floor(y2 @ yuv_mod._INV + 0.5), 0, maxv)
        ref2 = (out.astype(np.uint16) >> (bd - 8)).astype(np.uint8) \
            if bd == 10 else out.astype(np.uint8)
        np.testing.assert_array_equal(
            nat2.reshape(-1, 3), ref2.reshape(-1, 3))


def test_avif_input_preserves_high_bit_depth(tmp_path):
    """A 10-bit AVIF input loads as hbd 16-bit (reference io.zig:525-532
    left-shifts HBD to 16) instead of Pillow's 8-bit downconvert."""
    import numpy as np

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.backend import EncCtx
    from oavif_jax.io.image import Image, load_image
    from oavif_jax.options import EncOptions

    rng = np.random.default_rng(0)
    rgb = np.clip(
        128 + 40 * np.sin(np.mgrid[0:96, 0:128][1] / 9)[..., None]
        + rng.normal(0, 8, (96, 128, 3)),
        0, 255,
    ).astype(np.uint8)
    ctx = EncCtx(
        o=EncOptions(tenbit=True),
        src=Image(width=128, height=96, channels=3, hbd=False, data=rgb),
        rgb=rgb, w=128, h=96, q=85,
    )
    data, _ = encode_avif_with_recon(ctx)
    p = tmp_path / "in10.avif"
    p.write_bytes(data)
    img = load_image(str(p))
    assert img.hbd and img.data.dtype == np.uint16 and img.channels == 3
    assert (img.data & 0x3F == 0).all()  # 10-bit left-shifted by 6

"""128x128 superblock conformance: partition tree, chunked residual
order, and the flat-gate NONE policy, bit-exact vs dav1d.

The reference gets 128px superblocks from libaom behind
avifEncoderAddImage (reference src/io.zig:629-632); our sequence can
choose either SB size (use_128x128_superblock). Key normative facts
pinned here (each desyncs if wrong):

  * blocks wider/taller than 64 code their residual in 64x64 CHUNKS
    with the planes interleaved per chunk (spec residual()), not
    plane-major;
  * the luma all-zero (txb_skip) context is 0 only when the tx covers
    the WHOLE block — a 128 block's TX_64X64 units take the
    neighbor-derived context;
  * tile_info's superblock units follow the sequence SB size (the
    64-based count desyncs single-SB-row/col frames).
"""

from __future__ import annotations

import numpy as np
import pytest

from oavif_jax.av1.frame import TileEncoder
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream


def _roundtrip(planes, q, force_none=False, bd=8):
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    h, w = planes[0].shape
    te = TileEncoder([p.copy() for p in planes], q, bd, 9, sb128=True)
    if force_none:
        te._force_sb128_none_test = True
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, bit_depth=bd,
                         use_128x128_superblock=True)
    fr = FrameConfig(width=w, height=h, base_q_idx=q,
                     use_128x128_superblock=True)
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), w, h,
                    bit_depth=bd, high_bitdepth=bd == 10)
    dec, _, _ = decode_to_yuv(data)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], te.recon[i][:h, :w])
    return te


def test_sb128_none_with_coefficients_all_shapes():
    """Forced 128-NONE roots with nonzero coefficients in every plane,
    across single/multi SB-row/col frames (the tile_info trap)."""
    for h, w in ((128, 128), (128, 256), (256, 128), (256, 256)):
        yy = np.mgrid[0:h, 0:w][0]
        planes = [np.asarray(100 + yy // 8, np.int32)] * 3
        te = _roundtrip(planes, 60, force_none=True)
        assert sum(1 for b in te.blocks if b[2] == 128) == (h // 128) * (
            w // 128)


def test_sb128_partial_superblocks():
    """Frames not multiple of 128: hanging roots split (the 32/64
    convention extended), split_or_horz/vert derived bools at 128."""
    rng = np.random.default_rng(4)
    for h, w in ((200, 136), (160, 320), (192, 192)):
        planes = [np.asarray(128 + rng.integers(-50, 50, (h, w)), np.int32)
                  for _ in range(3)]
        _roundtrip(planes, 80)


def test_sb128_flat_gate_selects_none_organically():
    """The product policy: a flat half yields 128-NONE roots, the noisy
    half splits; the whole stream decodes exactly."""
    rng = np.random.default_rng(4)
    planes = [np.asarray(128 + rng.integers(-70, 70, (256, 256)), np.int32)
              for _ in range(3)]
    for p in range(3):
        planes[p][:, :128] = 90 + p * 5
    te = _roundtrip(planes, 100)
    n128 = sum(1 for b in te.blocks if b[2] == 128)
    assert n128 >= 1


def test_sb128_10bit():
    yy = np.mgrid[0:256, 0:256][0]
    planes = [np.asarray(400 + yy // 8 + p * 30, np.int32) for p in range(3)]
    _roundtrip(planes, 90, force_none=True, bd=10)


def test_sb128_loop_filter_and_cdef_exact():
    """A coded 128-NONE block through the full in-loop sandwich: the
    chroma tx caps at 32, so a 128 block has THREE internal chroma LF
    edges per direction (the 64-block rule hardcoded one — regression
    pinned here)."""
    from oavif_jax.io.avif_ctypes import decode_to_yuv
    from oavif_jax.av1.cdef import cdef_frame
    from oavif_jax.av1.frame import encode_frame_planes
    from oavif_jax.av1.loopfilter import loop_filter_frame

    rgb = np.full((128, 128, 3), 120, np.uint8)
    rgb[64:, :, 0] = 180
    from oavif_jax.av1.yuv import rgb_to_yuv444

    planes = rgb_to_yuv444(rgb, bitdepth=8)
    payloads, recon, blocks = encode_frame_planes(
        planes, 152, speed=9, sb128=True, use_device_planner=False)
    assert any(b[2] == 128 for b in blocks)
    loop_filter_frame(recon, blocks, (12, 12, 12, 12), bitdepth=8,
                      visible=(128, 128))
    cdef_frame(recon, blocks, (4, 2, 4, 2), 3, 8)
    recon = [p[:128, :128] for p in recon]
    seq = SequenceConfig(width=128, height=128, use_128x128_superblock=True,
                         enable_cdef=True)
    fr = FrameConfig(width=128, height=128, base_q_idx=152,
                     filter_levels=(12, 12, 12, 12), enable_cdef=True,
                     cdef_damping=3, cdef_strengths=((4, 2, 4, 2),),
                     use_128x128_superblock=True)
    data = mux_avif(assemble_av1_stream(seq, fr, payloads), 128, 128)
    dec, _, _ = decode_to_yuv(data)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], recon[i])


def test_sb128_c_python_byte_identity():
    """Both mirrored coders produce identical sb128 streams, including
    the two-gate 128 partition duel."""
    from oavif_jax.av1.entropy.fast import get_lib, tile_encode_native

    if get_lib() is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(4)
    noisy = [np.asarray(128 + rng.integers(-70, 70, (256, 256)), np.int32)
             for _ in range(3)]
    mix = [n.copy() for n in noisy]
    for p in range(3):
        mix[p][:, :128] = 90 + p * 5
    for q in (60, 110, 152):
        te = TileEncoder([p.copy() for p in mix], q, 8, 9, sb128=True)
        py = te.encode()
        res = tile_encode_native([p.copy() for p in mix], q, 8, 9,
                                 None, 0, sb128=True)
        assert res is not None and res[0] == py
        for a, b in zip(res[1], te.recon):
            np.testing.assert_array_equal(a, b)


def test_sb128_product_path_decodes_exact():
    """encode_avif_with_recon with the sb128 default: shipped bytes
    decode (dav1d) to exactly the scored recon."""
    import types as pytypes

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.av1.yuv import yuv444_to_rgb
    from oavif_jax.io.avif_ctypes import decode_to_yuv
    from oavif_jax.options import EncOptions

    rng = np.random.default_rng(8)
    yy = np.mgrid[0:256, 0:256][0]
    img = np.clip(
        110 + yy[..., None] // 16 * np.ones(3)
        + rng.normal(0, 3, (256, 256, 3)), 0, 255
    ).astype(np.uint8)
    src = pytypes.SimpleNamespace(data=img, channels=3, hbd=False, icc=None)
    o = EncOptions()
    o.tenbit = 0
    ctx = pytypes.SimpleNamespace(o=o, src=src, q=55)
    data, recon = encode_avif_with_recon(ctx)
    yuv, depth, _ = decode_to_yuv(data)
    dec_rgb = yuv444_to_rgb([p for p in yuv], bitdepth=depth)
    np.testing.assert_array_equal(dec_rgb, recon)


def test_sb128_deep_split_content_matches_sb64_quality():
    """A full-noise sb128 frame splits every root to the normal 64 tree:
    recon must equal content-wise what the sb64 encoding produces (same
    block decisions; only the partition root differs)."""
    rng = np.random.default_rng(11)
    planes = [np.asarray(128 + rng.integers(-70, 70, (256, 256)), np.int32)
              for _ in range(3)]
    te128 = _roundtrip(planes, 60)
    te64 = TileEncoder([p.copy() for p in planes], 60, 8, 9)
    te64.encode()
    for a, b in zip(te128.recon, te64.recon):
        np.testing.assert_array_equal(a, b)


def test_sb128_edge_availability_with_plan_decodes_exact():
    """Regression: the C coder's has_top_right/bottom_left recursion was
    hardcoded to 64px superblocks, so TR/BL prediction-edge availability
    inside 128 superblocks diverged from the decoder's (spec recursion
    runs to the SB root). Oriented-stripe content + the device plan's
    directional nominees is exactly the bait: the planned 16-blocks read
    top-right edges. Pins decode==recon through the PRODUCT path on the
    C coder with a plan, and C<->Python byte parity with the same plan."""
    import types as pytypes

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.frame import _get_planner
    from oavif_jax.av1.yuv import rgb_to_yuv444, yuv444_to_rgb
    from oavif_jax.io.avif_ctypes import decode_to_yuv
    from oavif_jax.options import EncOptions

    rng = np.random.default_rng(1017)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    ang = 0.9
    g = 128 + 90 * np.sin((xx * np.cos(ang) + yy * np.sin(ang)) / 6)
    img = np.clip(
        np.stack([g, g, g], -1) + rng.normal(0, 4, (256, 256, 3)), 0, 255
    ).astype(np.uint8)

    # product path (C coder + device plan + sb128 default-on)
    src = pytypes.SimpleNamespace(data=img, channels=3, hbd=False, icc=None)
    o = EncOptions()
    o.tenbit = 0
    o.speed = 8
    ctx = pytypes.SimpleNamespace(o=o, src=src, q=65)
    data, recon = encode_avif_with_recon(ctx)
    yuv, depth, _ = decode_to_yuv(data)
    dec_rgb = yuv444_to_rgb([p for p in yuv], bitdepth=depth)
    np.testing.assert_array_equal(dec_rgb, recon)

    # C <-> Python byte parity with the same plan
    planes = [np.asarray(p, np.int32) for p in rgb_to_yuv444(img, 8)]
    plan = _get_planner(planes, 8, 13, 0, 0).plan(88)
    te = TileEncoder([p.copy() for p in planes], 88, 8, 8, plan=plan,
                     filter_intra=True, sb128=True)
    py = te.encode()
    res = tile_encode_native(planes, 88, 8, 8, plan, 0,
                             filter_intra=True, sb128=True)
    if res is None:
        pytest.skip("native library unavailable")
    assert res[0] == py

"""Bitstream conformance: our encoder's output must decode through the
independent libavif/dav1d decoder, bit-exact with our reconstruction
(SURVEY.md §4a — the reference decoder as oracle)."""

import numpy as np
import pytest
from PIL import Image as PILImage

from oavif_jax.av1 import frame as frame_mod
from oavif_jax.av1.encode import encode_avif_with_recon
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream
from oavif_jax.backend import EncCtx
from oavif_jax.io.image import Image
from oavif_jax.options import EncOptions


def _encode(rgb, q=60, speed=9):
    h, w = rgb.shape[:2]
    img = Image(width=w, height=h, channels=3, hbd=False, data=rgb)
    # explicit 8-bit for these tests (the EncOptions default is 10-bit,
    # matching the reference's --tenbit default)
    ctx = EncCtx(
        o=EncOptions(speed=speed, tenbit=False), src=img, rgb=rgb, w=w, h=h, q=q
    )
    return encode_avif_with_recon(ctx)


def _decode(data):
    import io

    im = PILImage.open(io.BytesIO(data))
    im.load()
    return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize(
    "shape", [(16, 16), (32, 32), (64, 64), (48, 48), (96, 80), (64, 129)]
)
def test_flat_images_roundtrip_exact(shape):
    rgb = np.full(shape + (3,), 128, np.uint8)
    data, recon = _encode(rgb)
    dec = _decode(data)
    np.testing.assert_array_equal(dec, recon)


def test_textured_image_recon_matches_decoder(test_rgb8):
    data, recon = _encode(test_rgb8, q=60)
    dec = _decode(data)
    # YUV recon is bit-exact (probe-tested); RGB conversion may differ ±1
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


def test_tx_split_streams_decode_exact():
    """TX_MODE_SELECT: force content + q where the tx-depth RD picks
    splits (verified via blocks[]), then check the independent decoder
    agrees (tx_depth ctx, per-txb prediction edges, sub-txb skip ctx,
    and the tx-aware loop filter are all load-bearing here). The RGB
    window allows the usual ±1 conversion wobble; YUV is bit-exact."""
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    d_rng = np.random.default_rng(77)
    h, w = 120, 152
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 80 * np.sin(xx / 7) * np.cos(yy / 5)
    rgb = np.clip(
        np.stack([base, base * 0.8 + 30, 255 - base], -1)
        + d_rng.normal(0, 10, (h, w, 3)),
        0,
        255,
    ).astype(np.uint8)
    for q in (88, 94):
        data, recon = _encode(rgb, q=q)
        dec = _decode(data)
        assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1
    # confirm splits actually occur: quadrant-localized texture makes the
    # 4-way tx split win (finer prediction + cheaper flat quadrants)
    quad = np.full((64, 96, 3), 128, np.float64)
    yy2, xx2 = np.mgrid[0:16, 0:16].astype(np.float64)
    for bx in range(0, 96, 32):
        quad[0:16, bx : bx + 16, :] += (
            60 * np.sin(xx2 * 2.2) * np.cos(yy2 * 1.7)
        )[..., None]
    quad8 = np.clip(quad + d_rng.normal(0, 2, quad.shape), 0, 255).astype(
        np.uint8
    )
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(quad8, 8)]
    found = False
    for qidx in (60, 100, 140, 180):
        # speed 8: the split trial runs for every block size (speed 9
        # gates it to <=16 blocks for throughput)
        te = TileEncoder(planes, qidx, 8, 8)
        te.encode()
        if any(b[4] < min(b[2], 64) for b in te.blocks):
            found = True
            break
    assert found


def test_skip64_flat_region_decodes_exact():
    """A flat 64-SB becomes a skip 64 block; the decoder must agree
    (regression for internal-chroma-tx-edge loop-filter handling). YUV
    recon is bit-exact; RGB conversion wobbles ±1 at filtered rows."""
    rgb = np.full((128, 128, 3), 120, np.uint8)
    rgb[64:, :, 0] = 180  # second SB row differs so LF has work
    data, recon = _encode(rgb, q=40)
    dec = _decode(data)
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


def test_quality_ordering(test_rgb8):
    sizes = {}
    maes = {}
    for q in (20, 50, 85):
        data, _ = _encode(test_rgb8, q=q)
        dec = _decode(data)
        sizes[q] = len(data)
        maes[q] = np.abs(dec.astype(int) - test_rgb8.astype(int)).mean()
    assert sizes[20] < sizes[50] < sizes[85]
    assert maes[20] > maes[50] > maes[85]


def test_single_coefficient_probes_bit_exact():
    """Decoder recon equals ours for crafted coefficient patterns (the
    transform/dequant bit-exactness anchor)."""
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    planes = [np.full((32, 32), 128, np.int32) for _ in range(3)]
    orig = frame_mod.TileEncoder._quantize

    def probe(lv):
        def q(self, resid, tx, tx_type="dct_dct", ptype=0):
            q.calls += 1
            return lv.copy() if q.calls == 1 else np.zeros((tx, tx), np.int64)

        q.calls = 0
        frame_mod.TileEncoder._quantize = q
        try:
            te = frame_mod.TileEncoder(planes, 100, 8, 9)
            tile = te.encode()
        finally:
            frame_mod.TileEncoder._quantize = orig
        mine = te.recon[0][:32, :32].copy()
        seq = SequenceConfig(width=32, height=32)
        fr = FrameConfig(width=32, height=32, base_q_idx=100)
        data = mux_avif(assemble_av1_stream(seq, fr, [tile]), 32, 32)
        yuv, _, _ = decode_to_yuv(data)
        return yuv[0], mine

    rng = np.random.default_rng(7)
    cases = [(0, 0, 5), (0, 1, -42), (1, 1, 7), (31, 31, 4), (0, 0, -264)]
    for r, c, v in cases:
        lv = np.zeros((32, 32), np.int64)
        lv[r, c] = v
        dec, mine = probe(lv)
        np.testing.assert_array_equal(dec, mine, err_msg=f"probe {(r, c, v)}")
    dense = (rng.integers(-6, 7, (32, 32)) * (rng.random((32, 32)) < 0.1)).astype(
        np.int64
    )
    dec, mine = probe(dense)
    np.testing.assert_array_equal(dec, mine)


def test_system_decoder_agrees(test_rgb8):
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    data, _ = _encode(test_rgb8, q=70)
    yuv, depth, _ = decode_to_yuv(data)
    assert depth == 8
    assert yuv[0].shape == test_rgb8.shape[:2]


def test_tenbit_roundtrip(test_rgb8):
    from oavif_jax.options import EncOptions

    h, w = test_rgb8.shape[:2]
    img = Image(width=w, height=h, channels=3, hbd=False, data=test_rgb8)
    ctx = EncCtx(o=EncOptions(tenbit=True), src=img, rgb=test_rgb8, w=w, h=h, q=60)
    data, recon = encode_avif_with_recon(ctx)
    # the strict check: decoder YUV planes are bit-exact with our recon
    from oavif_jax.av1.consts import quality_to_qindex
    from oavif_jax.av1.encode import _depth_convert
    from oavif_jax.av1.frame import encode_frame_planes
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    planes, depth, _ = decode_to_yuv(data)
    assert depth == 10
    from oavif_jax.av1.encode import _filter_level
    from oavif_jax.av1.loopfilter import loop_filter_frame

    qi = quality_to_qindex(60)
    pl = rgb_to_yuv444(_depth_convert(test_rgb8, False, 10), bitdepth=10)
    from oavif_jax.av1.encode import _chroma_delta_q
    _, ours, blocks = encode_frame_planes(
        pl, qi, 10, 9, u_ac_delta_q=_chroma_delta_q(qi, "iq", pl, 10))
    flv = _filter_level(qi)
    hh, ww = test_rgb8.shape[:2]
    if flv:
        loop_filter_frame(ours, blocks, (flv,) * 4, bitdepth=10,
                          visible=(hh, ww))
    from oavif_jax.av1.cdef import cdef_frame
    from oavif_jax.av1.encode import _pick_cdef

    st, damp = _pick_cdef(pl, ours, blocks, qi, 10, (hh, ww))
    if any(st):
        cdef_frame(ours, blocks, st, damp, 10)
    for a, b in zip(planes, ours):
        np.testing.assert_array_equal(a, b[:hh, :ww])
    # the 8-bit RGB window (reference main.zig:86): ours and PIL's 10->8
    # conversions round differently, so allow a small tolerance
    dec = _decode(data)
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 3


def test_alpha_item_roundtrip(test_rgb8):
    import io

    from oavif_jax.options import EncOptions

    h, w = test_rgb8.shape[:2]
    a = np.linspace(30, 250, w, dtype=np.uint8)[None, :].repeat(h, 0)
    rgba = np.dstack([test_rgb8, a])
    img = Image(width=w, height=h, channels=4, hbd=False, data=rgba)
    ctx = EncCtx(
        o=EncOptions(tenbit=False, quality_alpha=85),
        src=img, rgb=test_rgb8, w=w, h=h, q=60,
    )
    data, _ = encode_avif_with_recon(ctx)
    im = PILImage.open(io.BytesIO(data))
    im.load()
    assert "A" in im.mode
    deca = np.asarray(im.convert("RGBA"))
    assert np.abs(deca[..., 3].astype(int) - a.astype(int)).mean() < 2.0


def _encode_tiled(rgb, q=60, tcl=1, trl=1, threads=1):
    h, w = rgb.shape[:2]
    img = Image(width=w, height=h, channels=3, hbd=False, data=rgb)
    ctx = EncCtx(
        o=EncOptions(
            speed=9, tenbit=False, auto_tiling=False,
            tile_cols_log2=tcl, tile_rows_log2=trl, max_threads=threads,
        ),
        src=img, rgb=rgb, w=w, h=h, q=q,
    )
    return encode_avif_with_recon(ctx)


@pytest.mark.parametrize("shape,tcl,trl", [
    ((128, 128), 1, 1),   # 2x2 tiles, exact SB multiples
    ((192, 128), 1, 2),   # uneven rows
    ((130, 200), 2, 1),   # non-SB-aligned frame, last tiles clipped
    ((96, 320), 3, 0),    # request > available SBs on rows (grid clamps)
])
def test_tiled_roundtrip_matches_decoder(test_rgb8, shape, tcl, trl):
    h, w = shape
    rng = np.random.default_rng(3)
    base = np.asarray(
        PILImage.fromarray(test_rgb8).resize((w, h), PILImage.BILINEAR)
    )
    rgb = np.clip(base.astype(int) + rng.integers(-4, 5, base.shape), 0, 255
                  ).astype(np.uint8)
    data, recon = _encode_tiled(rgb, q=60, tcl=tcl, trl=trl)
    dec = _decode(data)
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


def test_tiled_threads_bitstream_identical(test_rgb8):
    """Thread-parallel tile encode must produce byte-identical output."""
    d1, _ = _encode_tiled(test_rgb8, tcl=1, trl=1, threads=1)
    d4, _ = _encode_tiled(test_rgb8, tcl=1, trl=1, threads=4)
    assert d1 == d4


def test_tile_grid_spec_counts():
    from oavif_jax.av1.obu import tile_grid

    # 5 SBs across, log2=2 → tile width ceil(5/4)=2 → 3 tiles (spec loop)
    cols, rows = tile_grid(5 * 64, 64, 2, 0)
    assert cols == [0, 2, 4, 5]
    assert rows == [0, 1]


def test_native_tile_encoder_matches_python_reference(test_rgb8):
    """The C tile encoder (oav1tile.c) must emit the identical bitstream
    and reconstruction as the Python reference TileEncoder."""
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.yuv import rgb_to_yuv444

    planes = rgb_to_yuv444(test_rgb8, bitdepth=8)
    native = tile_encode_native([p.copy() for p in planes], 80, 8, 9)
    if native is None:
        pytest.skip("native library unavailable")
    te = TileEncoder([p.copy() for p in planes], 80, 8, 9)
    py_payload = te.encode()
    h, w = planes[0].shape
    assert native[0] == py_payload
    for pi in range(3):
        np.testing.assert_array_equal(native[1][pi], te.recon[pi][:h, :w])


def test_native_tile_encoder_odd_sizes_and_10bit():
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.entropy.fast import tile_encode_native

    rng = np.random.default_rng(11)
    for (h, w, bd) in [(96, 130, 8), (64, 64, 10), (40, 72, 8)]:
        mx = (1 << bd) - 1
        planes = [
            rng.integers(0, mx + 1, (h, w)).astype(np.int32) for _ in range(3)
        ]
        native = tile_encode_native([p.copy() for p in planes], 60, bd, 9)
        if native is None:
            pytest.skip("native library unavailable")
        te = TileEncoder([p.copy() for p in planes], 60, bd, 9)
        py_payload = te.encode()
        assert native[0] == py_payload, (h, w, bd)


@pytest.mark.parametrize("corr", ["pos_neg", "gray_ctx5", "mixed"])
def test_cfl_roundtrip_matches_decoder(corr):
    """CfL (chroma-from-luma) bitstreams must decode bit-exactly, covering
    multiple joint-sign contexts (incl. the ctx-5 (+,+) path whose default
    CDF was pinned against a corrupt-looking libaom .rodata row)."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    L = np.clip(128 + 100 * np.sin(xx / 13) * np.cos(yy / 19)
                + rng.normal(0, 4, (128, 128)), 0, 255)
    if corr == "pos_neg":
        img = np.stack([L * 0.9 + 20, L * 0.8, 255 - L * 0.7], -1)
    elif corr == "gray_ctx5":
        img = np.stack([L, L, L], -1)
    else:
        img = np.stack([L, 255 - L * 0.5, L * 0.3 + 100], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    data, recon = _encode(img, q=60)
    dec = _decode(data)
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


@pytest.mark.parametrize("q,shape", [(85, (96, 96)), (60, (130, 98)), (90, (64, 64))])
def test_partition_split_roundtrip(q, shape):
    """16x16 leaves (RD split + intra_tx_type signaling) must decode
    bit-exactly, including partial-node 8x8/16x16 leaves at odd sizes."""
    rng = np.random.default_rng(13)
    h, w = shape
    img = np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    data, recon = _encode(img, q=q)
    dec = _decode(data)
    assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


def test_adst_selected_streams_roundtrip(test_rgb8):
    """Streams where the RD search picks ADST for some luma txbs must
    decode bit-exactly (intra_tx_type symbol + inverse ADST conformance)."""
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    img = np.clip(
        np.stack([128 + 110 * np.sin((xx + yy) / 9),
                  120 + 80 * np.sin((xx + yy) / 13),
                  100 + 90 * np.sin((xx - yy) / 17)], -1)
        + rng.normal(0, 4, (128, 128, 3)), 0, 255).astype(np.uint8)
    for q in (60, 85):
        data, recon = _encode(img, q=q)
        dec = _decode(data)
        assert np.abs(dec.astype(int) - recon.astype(int)).max() <= 1


def test_planner_streams_decode_exact(test_rgb8):
    """Product path with the device planner forced ON at small sizes:
    planned partition/mode decisions must still produce dav1d-exact
    streams (the plan pins decisions, not reconstruction)."""
    import numpy as np

    from oavif_jax.av1.device_plan import FramePlanner
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rgb = np.tile(test_rgb8, (2, 2, 1))[:128, :192]  # 2x3 SBs
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    for qindex in (40, 120):
        plan = FramePlanner(planes, 8).plan(qindex)
        assert plan is not None and plan["mode32"].shape == (4, 6)
        te = TileEncoder([p.copy() for p in planes], qindex, 8, 9,
                         plan=plan, u_ac_delta_q=24)
        py = te.encode()
        res = tile_encode_native(planes, qindex, 8, 9, plan, 24)
        assert res is not None and res[0] == py
        # the plan must actually pin decisions somewhere
        assert (plan["plan64"] >= 0).all()


def test_rect_horz_32x16_stream_decodes_exact():
    """Rectangular-partition slice: PARTITION_HORZ at 32 -> two 32x16
    blocks with TX_32X16 (tx == block, DC modes, no tx_type syntax).
    Everything rect is load-bearing here — the HORZ partition symbol and
    rect context bytes, the rect scan table, eob_pt_512 class, rect
    coefficient contexts, the rect dequant shift ((pels>256)+(pels>1024))
    and the rect inverse transform's sqrt2 stage + row shift (one less
    than the square schedule; dav1d-disasm-verified) — and the
    independent decoder must agree bit-exactly with the encoder's
    reconstruction."""
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig,
        SequenceConfig,
        assemble_av1_stream,
    )
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    rng2 = np.random.default_rng(123)
    h, w = 64, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 70 * np.sin(xx / 9) * np.cos(yy / 6)
    rgb = np.clip(
        np.stack([base, 0.8 * base + 20, 255 - 0.7 * base], -1)
        + rng2.normal(0, 8, (h, w, 3)),
        0,
        255,
    ).astype(np.uint8)
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    for qindex in (40, 80, 140):
        te = TileEncoder([p.copy() for p in planes], qindex, 8, 9)
        te._force_rect_test = True
        payload = te.encode()
        seq = SequenceConfig(width=w, height=h, bit_depth=8)
        frame = FrameConfig(width=w, height=h, base_q_idx=qindex)
        av1 = assemble_av1_stream(seq, frame, [payload])
        avif = mux_avif(av1, w, h, bit_depth=8, high_bitdepth=False,
                        cicp=(2, 2, 2))
        yuv, bd, rng_flag = decode_to_yuv(avif)
        for pi, (ours, dec) in enumerate(zip(te.recon, yuv)):
            np.testing.assert_array_equal(
                ours[:h, :w], dec, err_msg=f"plane {pi} qindex {qindex}"
            )


def test_rect_rd_full_pipeline_decodes_exact(monkeypatch):
    """RD-gated rect partitions (HORZ and VERT chosen by the partition
    search, not forced) through the FULL pipeline — modes, CfL chroma,
    RDOQ, loop filter with per-direction rect tx maps, CDEF with rect
    skip maps, mux — must decode bit-exactly via dav1d."""
    import os

    from oavif_jax.av1.cdef import cdef_frame
    from oavif_jax.av1.consts import quality_to_qindex
    from oavif_jax.av1.encode import (
        _chroma_delta_q, _filter_level, _pick_cdef,
    )
    from oavif_jax.av1.frame import TileEncoder, encode_frame_planes
    from oavif_jax.av1.loopfilter import loop_filter_frame
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    monkeypatch.setenv("OAVIF_PY_TILE", "1")
    monkeypatch.setattr(TileEncoder, "_enable_rect", True)
    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.backend import EncCtx
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions

    rng2 = np.random.default_rng(3)
    h, w = 192, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 80 * np.sin(yy / 5) + 40 * np.sin(xx / 4.2) * (xx > 80)
    rgb = np.clip(
        np.stack([base, 0.9 * base, 255 - 0.6 * base], -1)
        + rng2.normal(0, 6, (h, w, 3)), 0, 255,
    ).astype(np.uint8)

    qi = quality_to_qindex(70)
    pl = rgb_to_yuv444(rgb, 8)
    _, ours, blocks = encode_frame_planes(
        pl, qi, 8, 9, u_ac_delta_q=_chroma_delta_q(qi, "iq", pl, 8))
    nrect = sum(1 for b in blocks if (b[2] >> 16))
    assert nrect > 0, "RD search should pick rect on oriented content"
    img = Image(width=w, height=h, channels=3, hbd=False, data=rgb)
    ctx = EncCtx(o=EncOptions(tenbit=False), src=img, rgb=rgb, w=w, h=h,
                 q=70)
    data, _ = encode_avif_with_recon(ctx)
    yuv, _, _ = decode_to_yuv(data)
    flv = _filter_level(qi)
    if flv:
        loop_filter_frame(ours, blocks, (flv,) * 4, bitdepth=8,
                          visible=(h, w))
    st, damp = _pick_cdef(pl, ours, blocks, qi, 8, (h, w))
    if any(st):
        cdef_frame(ours, blocks, st, damp, 8)
    for pi, (a, b) in enumerate(zip(yuv, ours)):
        np.testing.assert_array_equal(a, b[:h, :w], err_msg=f"plane {pi}")


def test_rect_c_python_byte_parity():
    """The C tile encoder mirrors the Python rect path byte-for-byte:
    same partition duel, same mode ladder, same rect RDOQ, same CfL
    decision, same symbols."""
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rng2 = np.random.default_rng(17)
    h, w = 192, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (120 + 70 * np.sin(yy / 6) * np.cos(xx / 17)
            + 30 * (np.sin(xx / 3.5) > 0.3))
    rgb = np.clip(
        np.stack([base, 0.8 * base + 25, 240 - 0.55 * base], -1)
        + rng2.normal(0, 7, (h, w, 3)), 0, 255,
    ).astype(np.uint8)
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    rect_seen = 0
    for speed, qindex in ((9, 50), (8, 50), (6, 100)):
        te = TileEncoder([p.copy() for p in planes], qindex, 8, speed)
        te._enable_rect = True
        py = te.encode()
        res = tile_encode_native(planes, qindex, 8, speed, None, 0)
        if res is None:
            pytest.skip("native library unavailable")
        assert res[0] == py, (speed, qindex)
        rect_seen += sum(1 for b in te.blocks if (b[2] >> 16))
    assert rect_seen > 0


def test_rect_syntax_decodes_exact_levels():
    """What IS proven for the rect slice: the complete rect SYNTAX round-
    trips through the independent decoder — HORZ partition symbols, rect
    context bytes, TX_32X16 tx-size coding, the rect scan table, the
    eob_pt_512 class, rect coefficient base/br contexts (extracted
    per-tx-size offset tables: wide txs +16 on the first two columns,
    tall +11 on the first two rows) and the rect dequant shift rule
    (area>=1024) + (area>=4096). A DC-only stream reconstructs BIT-EXACT;
    multi-coefficient txbs decode the exact same LEVELS with recon within
    rounding distance (the decoder's exact rect inverse rounding sequence is the one
    remaining open item, tracked by the xfail test above)."""
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig,
        SequenceConfig,
        assemble_av1_stream,
    )
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    h, w = 32, 64
    # DC-only: constant planes -> bit-exact round trip
    planes = [np.full((h, w), v, np.int32) for v in (150, 120, 100)]
    te = TileEncoder([p.copy() for p in planes], 40, 8, 9)
    te._force_rect_test = True
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, bit_depth=8)
    frame = FrameConfig(width=w, height=h, base_q_idx=40)
    avif = mux_avif(assemble_av1_stream(seq, frame, [payload]), w, h,
                    bit_depth=8, high_bitdepth=False, cicp=(2, 2, 2))
    yuv, _, _ = decode_to_yuv(avif)
    for ours, dec in zip(te.recon, yuv):
        np.testing.assert_array_equal(ours[:h, :w], dec)

    # textured: multi-coefficient txbs round-trip bit-exact too
    rng2 = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 60 * np.sin(xx / 9) * np.cos(yy / 6)
    rgbish = [
        np.clip(base + rng2.normal(0, 7, (h, w)), 0, 255).astype(np.int32)
        for _ in range(3)
    ]
    te = TileEncoder([p.copy() for p in rgbish], 40, 8, 9)
    te._force_rect_test = True
    payload = te.encode()
    avif = mux_avif(
        assemble_av1_stream(seq, frame, [payload]), w, h, bit_depth=8,
        high_bitdepth=False, cicp=(2, 2, 2),
    )
    yuv, _, _ = decode_to_yuv(avif)
    for pi, (ours, dec) in enumerate(zip(te.recon, yuv)):
        np.testing.assert_array_equal(ours[:h, :w], dec, err_msg=str(pi))

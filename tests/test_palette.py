"""Palette mode (screen-content tool, spec 5.11.46-51): dav1d-exact
streams and the coding gains it exists for."""
import os

import numpy as np
import pytest


def _roundtrip(rgb, qindex=60, screen_tools=True, force=False):
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig, SequenceConfig, assemble_av1_stream,
    )
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    h, w = rgb.shape[:2]
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    used = [0]
    te = TileEncoder([p.copy() for p in planes], qindex, 8, 9,
                     screen_tools=screen_tools)
    orig = te._try_palette_y
    def spy(x, y, size):
        r = orig(x, y, size)
        if r is None:
            return None
        used[0] += 1
        return (r[0], r[1], 0, 0) if force else r
    te._try_palette_y = spy
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, bit_depth=8)
    frame = FrameConfig(width=w, height=h, base_q_idx=qindex,
                        screen_content_tools=screen_tools)
    avif = mux_avif(assemble_av1_stream(seq, frame, [payload]), w, h,
                    bit_depth=8, high_bitdepth=False, cicp=(2, 2, 2))
    yuv, _, _ = decode_to_yuv(avif)
    for pi, (ours, dec) in enumerate(zip(te.recon, yuv)):
        np.testing.assert_array_equal(ours[:h, :w], dec, err_msg=str(pi))
    return used[0], len(payload), te


def test_palette_sizes_2_to_8_exact():
    """Every palette size decodes bit-exactly: color delta coding with
    the av1_ceil_log2 shrink, the truncated-binary first index, and the
    per-size color-index CDF banks."""
    xx = np.arange(16)[None, :] + np.arange(16)[:, None]
    for n in range(2, 9):
        vals = np.linspace(20, 220, n).astype(int)
        g = vals[xx % n].astype(float)
        rgb = np.stack([g, g, g], -1).astype(np.uint8)
        used, _, _ = _roundtrip(rgb, force=True)
        assert used >= 1, n


def test_palette_cache_reuse_exact():
    """Neighbor palette caches: full reuse, partial reuse (the
    explicit-color path with and without the extra-precision field),
    above+left merges, coexistence with rect partitions."""
    rng = np.random.default_rng(3)
    vals = np.array([20, 80, 150, 220])
    gm = vals[rng.integers(0, 4, (8, 8))].repeat(8, 0).repeat(8, 1)
    rgb = np.stack([gm, 255 - gm, gm // 2 + 40], -1).astype(np.uint8)
    used, _, _ = _roundtrip(rgb, force=True)
    assert used >= 4


def test_palette_rd_wins_on_screen_content():
    """The RD duel picks palette on flat-color content and it pays:
    measured -57..-65% bytes at HIGHER SSIMULACRA2 on the edges class."""
    yy, xx = np.mgrid[0:128, 0:128]
    ge = np.where((xx // 37 + yy // 23) % 2 == 0, 205.0, 70.0)
    ge += np.where((xx + 2 * yy) % 97 < 8, 40.0, 0.0)
    rgb = np.clip(
        np.stack([ge, 0.85 * ge + 20, 255 - 0.7 * ge], -1), 0, 255,
    ).astype(np.uint8)
    used_p, bytes_p, _ = _roundtrip(rgb, screen_tools=True)
    assert used_p > 0
    used_0, bytes_0, _ = _roundtrip(rgb, screen_tools=False)
    assert used_0 == 0
    assert bytes_p < bytes_0 * 0.75, (bytes_p, bytes_0)


def test_screen_frames_decline_flags_exact():
    """Screen-content frames code has_palette flags on every eligible
    DC block (including rect blocks); an all-decline stream is
    bit-exact too. Noisy content may now produce LOSSY palette
    candidates, but the D+lambda*R duel must decline them all: the
    payload must equal an encode with candidates suppressed."""
    rng = np.random.default_rng(7)
    g = np.clip(
        128 + 60 * np.sin(np.arange(64)[None, :] / 7)
        + rng.normal(0, 6, (64, 64)), 0, 255,
    )
    rgb = np.stack([g, g * 0.9 + 10, 255 - g * 0.7], -1).astype(np.uint8)
    used, nbytes, _ = _roundtrip(rgb, screen_tools=True)

    # suppressed-candidate twin (still screen_tools: flags still code)
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.yuv import rgb_to_yuv444

    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    te = TileEncoder([p.copy() for p in planes], 60, 8, 9,
                     screen_tools=True)
    te._try_palette_y = lambda x, y, size: None
    assert len(te.encode()) == nbytes


def test_palette_c_python_byte_parity():
    """The C tile encoder mirrors the palette path byte-for-byte: the
    duel, cache reuse, color deltas, index-map contexts and the decline
    flags on non-palette/rect blocks."""
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rng = np.random.default_rng(3)
    vals = np.array([20, 80, 150, 220])
    gm = vals[rng.integers(0, 4, (8, 8))].repeat(8, 0).repeat(8, 1)
    rgb = np.stack([gm, 255 - gm, gm // 2 + 40], -1).astype(np.uint8)
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    for qi, sp in ((40, 9), (80, 6)):
        te = TileEncoder([p.copy() for p in planes], qi, 8, sp,
                         screen_tools=True)
        py = te.encode()
        res = tile_encode_native(planes, qi, 8, sp, None, 0,
                                 screen_tools=True)
        if res is None:
            pytest.skip("native library unavailable")
        assert res[0] == py, (qi, sp)


def test_screen_content_detector():
    from oavif_jax.av1.encode import _detect_screen_content

    yy, xx = np.mgrid[0:128, 0:128]
    flat = np.where((xx // 16) % 2 == 0, 40, 200).astype(np.uint8)
    assert _detect_screen_content(flat, 60)
    rng = np.random.default_rng(1)
    noisy = np.clip(128 + rng.normal(0, 20, (128, 128)), 0, 255).astype(
        np.uint8)
    assert not _detect_screen_content(noisy, 60)


def _text_on_gradient_rgb(h=128, w=128, seed=19, density=24):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:h, 0:w][0].astype(np.float64)
    img = np.stack([200 + 40 * yy / h, 210 + 30 * yy / h,
                    225 + 20 * yy / h], -1)
    for _ in range(density):
        x0, y0 = rng.integers(4, w - 12), rng.integers(4, h - 14)
        glyph = rng.random((10, 7)) > 0.5
        col = float(rng.integers(0, 70))
        for c in range(3):
            ch = img[y0 : y0 + 10, x0 : x0 + 7, c]
            ch[glyph] = col
    return np.clip(img, 0, 255).astype(np.uint8)


def test_lossy_palette_10bit_parity_and_decode():
    """Lossy palette (the >8-distinct clustering path) on a 10-bit
    depth-converted text-on-gradient frame: the C and Python coders must
    agree byte-for-byte, at least one block must actually choose the
    lossy candidate, and the stream must decode bit-exactly."""
    from oavif_jax.av1.entropy.fast import tile_encode_native
    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig, SequenceConfig, assemble_av1_stream,
    )
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    rgb8 = _text_on_gradient_rgb()
    # the product's 8->10-bit depth conversion (io.zig formulas)
    from oavif_jax.av1.encode import _depth_convert

    rgb10 = _depth_convert(rgb8, False, 10)
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(rgb10, 10)]
    h, w = planes[0].shape
    qi = 60

    te = TileEncoder([p.copy() for p in planes], qi, 10, 9,
                     screen_tools=True)
    lossy_used = [0]
    orig = te._try_palette_y

    def spy(x, y, size):
        r = orig(x, y, size)
        if r is not None and r[3] > 0:
            lossy_used[0] += 1
        return r

    te._try_palette_y = spy
    py = te.encode()
    assert lossy_used[0] > 0, "no lossy palette candidates fired"

    res = tile_encode_native(planes, qi, 10, 9, None, 0, screen_tools=True)
    if res is None:
        pytest.skip("native library unavailable")
    assert res[0] == py

    seq = SequenceConfig(width=w, height=h, bit_depth=10)
    frame = FrameConfig(width=w, height=h, base_q_idx=qi,
                        screen_content_tools=True)
    avif = mux_avif(assemble_av1_stream(seq, frame, [py]), w, h,
                    bit_depth=10, high_bitdepth=True, cicp=(2, 2, 2))
    yuv, _, _ = decode_to_yuv(avif)
    for pi, (ours, dec) in enumerate(zip(te.recon, yuv)):
        np.testing.assert_array_equal(ours[:h, :w], dec, err_msg=str(pi))


def test_palette_color_delta_shrink_pow2_boundary():
    """Regression: the explicit-color delta coder's shrinking bit width
    must use the DECODER's range, maxVal - color = (1<<bd)-1-color
    (dav1d read_pal_plane). The old (1<<bd)-color range over-wrote one
    bit exactly when maxVal - color is a power of two (e.g. color 239 at
    8-bit: we wrote 5 bits, dav1d read 4), desyncing every symbol after
    — latent until lossy palette made clustered high colors common.
    Forces palettes whose shrink crosses the boundary and pins
    decode==recon via dav1d AND libaom."""
    import numpy as np

    from oavif_jax.av1.frame import TileEncoder
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig, SequenceConfig, assemble_av1_stream,
    )
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    rr, cc = np.mgrid[0:16, 0:16]
    for colors in ([0, 239, 243], [0, 223, 230],
                   [37, 233, 234, 235, 236, 237, 239, 240]):
        pal = np.asarray(colors, np.int32)
        y = pal[(cc % len(colors))]
        planes = [y.astype(np.int32),
                  np.full((16, 16), 128, np.int32),
                  np.full((16, 16), 128, np.int32)]
        te = TileEncoder([p.copy() for p in planes], 12, 8, 9,
                         screen_tools=True)
        orig = te._try_palette_y
        used = [0]

        def spy(x, yy, size, o=orig, used=used):
            r = o(x, yy, size)
            if r is None:
                return None
            used[0] += 1
            return (r[0], r[1], 0, 0)

        te._try_palette_y = spy
        payload = te.encode()
        assert used[0] >= 1
        seq = SequenceConfig(width=16, height=16, bit_depth=8)
        frame = FrameConfig(width=16, height=16, base_q_idx=12,
                            screen_content_tools=True)
        stream = assemble_av1_stream(seq, frame, [payload])
        avif = mux_avif(stream, 16, 16, bit_depth=8, high_bitdepth=False,
                        cicp=(2, 2, 2))
        yuv, _, _ = decode_to_yuv(avif)
        np.testing.assert_array_equal(
            np.asarray(te.recon[0])[:16, :16], yuv[0], err_msg=str(colors))
        try:
            from oavif_jax.io.aom_ctypes import decode_obu_to_yuv

            ayuv = decode_obu_to_yuv(stream)[0]
            np.testing.assert_array_equal(
                np.asarray(te.recon[0])[:16, :16], np.asarray(ayuv[0]),
                err_msg="libaom " + str(colors))
        except OSError:
            pass

"""Cross-decoder conformance: libaom's decoder as a SECOND oracle.

Every other conformance test holds streams to dav1d (via libavif,
the reference's own decode path — src/io.zig:638-666). These hold the
same streams to libaom's decoder too (io/aom_ctypes.py): two fully
independent AV1 implementations agreeing with our encoder-side recon
leaves essentially no room for a compensating-bug conformance hole.
The SGRPROJ xqd ref-mid off-by-one that masqueraded as filter rounding
noise for two rounds was cracked exactly this way.
"""

from __future__ import annotations

import numpy as np
import pytest

from oavif_jax.av1.frame import TileEncoder
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream


def _aom():
    from oavif_jax.io import aom_ctypes

    if not aom_ctypes.available():
        pytest.skip("libaom unavailable")
    return aom_ctypes.decode_obu_to_yuv


def _dav1d():
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    return decode_to_yuv


def _mixed_content(h, w, seed=3, bitdepth=8):
    rng = np.random.default_rng(seed)
    hi = (1 << bitdepth) - 1
    mid = 1 << (bitdepth - 1)
    x = np.linspace(0, 10, w)
    y = np.linspace(0, 10, h)
    grad = mid + (mid - 1) * 0.55 * np.sin(x[None, :] * 2 + y[:, None])
    out = []
    for p in range(3):
        pl = grad + rng.normal(0, hi * 0.04, (h, w))
        if p == 0:
            pl[h // 2 :, : w // 2] = rng.choice(
                [mid // 2, mid, mid + mid // 2], size=(h - h // 2, w // 2)
            )  # flat palette-shaped region
        out.append(np.clip(pl, 0, hi).astype(np.int32))
    return out


def _both_decodes(stream, w, h, bitdepth=8):
    aom_planes, aom_depth = _aom()(bytes(stream))
    data = mux_avif(stream, w, h, bit_depth=bitdepth,
                    high_bitdepth=bitdepth == 10)
    dav, dav_depth, _ = _dav1d()(data)
    assert aom_depth == dav_depth == bitdepth
    return aom_planes, dav


def test_aom_dav1d_ours_agree_plain():
    """Speed-9 stream (partition RD, rect arms, CfL, RDOQ active):
    libaom decode == dav1d decode == our recon, all planes."""
    h = w = 128
    planes = _mixed_content(h, w)
    for q in (50, 130):
        te = TileEncoder([p.copy() for p in planes], q, 8, 9)
        payload = te.encode()
        seq = SequenceConfig(width=w, height=h)
        fr = FrameConfig(width=w, height=h, base_q_idx=q)
        stream = assemble_av1_stream(seq, fr, [payload])
        aom_p, dav = _both_decodes(stream, w, h)
        for i in range(3):
            np.testing.assert_array_equal(aom_p[i], dav[i])
            np.testing.assert_array_equal(aom_p[i],
                                          te.recon[i][:h, :w])


def test_aom_dav1d_ours_agree_restoration_switchable():
    """SWITCHABLE loop restoration with Wiener + SGR + NONE units:
    both decoders and our apply_restoration agree bit-exactly."""
    from oavif_jax.av1.restoration import apply_restoration, count_units, \
        unit_size

    h, w = 160, 192
    planes = _mixed_content(h, w, seed=7)
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    wcfg = {0: [[None] * ucols for _ in range(urows)]}
    scfg = {0: [[None] * ucols for _ in range(urows)]}
    k = 0
    for ur in range(urows):
        for uc in range(ucols):
            m = k % 3
            k += 1
            if m == 0:
                wcfg[0][ur][uc] = [2, -5, 20, -1, 3, 30]
            elif m == 1:
                scfg[0][ur][uc] = ((9, -33, 52), (12, 0, 0))[(ur + uc) % 2]
    lr = {"types": (1, 0, 0), "unit_shift": 0, "wiener": wcfg,
          "sgrproj": scfg}
    te = TileEncoder([p.copy() for p in planes], 60, 8, 9, lr=lr)
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, enable_restoration=True)
    fr = FrameConfig(width=w, height=h, base_q_idx=60,
                     enable_restoration=True, lr_types=(1, 0, 0),
                     lr_unit_shift=0)
    stream = assemble_av1_stream(seq, fr, [payload])
    aom_p, dav = _both_decodes(stream, w, h)
    recon = [r.copy() for r in te.recon]
    ours = apply_restoration(recon, [r.copy() for r in recon], h, w,
                             (1, 0, 0), 0, wcfg, scfg, 8)
    for i in range(3):
        np.testing.assert_array_equal(aom_p[i], dav[i])
        np.testing.assert_array_equal(aom_p[i], ours[i])


def test_aom_dav1d_ours_agree_10bit():
    h = w = 96
    planes = _mixed_content(h, w, seed=11, bitdepth=10)
    te = TileEncoder([p.copy() for p in planes], 90, 10, 9)
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, bit_depth=10)
    fr = FrameConfig(width=w, height=h, base_q_idx=90)
    stream = assemble_av1_stream(seq, fr, [payload])
    aom_p, dav = _both_decodes(stream, w, h, bitdepth=10)
    for i in range(3):
        np.testing.assert_array_equal(aom_p[i], dav[i])
        np.testing.assert_array_equal(aom_p[i], te.recon[i][:h, :w])

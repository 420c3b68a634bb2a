"""Deblocking loop filter conformance: with nonzero loop_filter_level in
the header, the filtered reconstruction must equal the independent
decoder's output bit-exactly (the filter taps were identified against
dav1d; this guards them)."""

import numpy as np
import pytest

from oavif_jax.av1.consts import quality_to_qindex
from oavif_jax.av1.encode import _filter_level, encode_avif_with_recon
from oavif_jax.av1.frame import encode_frame_planes
from oavif_jax.av1.loopfilter import loop_filter_frame
from oavif_jax.av1.yuv import rgb_to_yuv444
from oavif_jax.backend import EncCtx
from oavif_jax.io.avif_ctypes import decode_to_yuv
from oavif_jax.io.image import Image
from oavif_jax.options import EncOptions


def _imgs():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    yield "grad", np.clip(
        np.stack([60 + 0.6 * xx + 0.2 * yy, 100 + 0.4 * yy, 200 - 0.5 * xx],
                 -1) + rng.normal(0, 2, (128, 128, 3)), 0, 255
    ).astype(np.uint8)
    yield "synth", np.clip(
        np.stack([128 + 100 * np.sin(xx / 17) * np.cos(yy / 23),
                  120 + 80 * np.cos(xx / 29), 100 + 90 * np.sin((xx + yy) / 31)],
                 -1) + rng.normal(0, 6, (128, 128, 3)), 0, 255
    ).astype(np.uint8)


@pytest.mark.parametrize("q", [50, 65, 80])
def test_loop_filtered_recon_matches_decoder(q):
    for name, img in _imgs():
        h, w = img.shape[:2]
        src = Image(width=w, height=h, channels=3, hbd=False, data=img)
        ctx = EncCtx(o=EncOptions(tenbit=False), src=src, rgb=img, w=w, h=h,
                     q=q)
        data, recon = encode_avif_with_recon(ctx)
        planes, _, _ = decode_to_yuv(data)
        qi = quality_to_qindex(q)
        pl = rgb_to_yuv444(img, bitdepth=8)
        from oavif_jax.av1.encode import _chroma_delta_q
        _, ours, blocks = encode_frame_planes(
            pl, qi, 8, 9, u_ac_delta_q=_chroma_delta_q(qi, "iq", pl, 8))
        flv = _filter_level(qi)
        assert flv > 0
        loop_filter_frame(ours, blocks, (flv,) * 4, bitdepth=8,
                          visible=(h, w))
        from oavif_jax.av1.cdef import cdef_frame
        from oavif_jax.av1.encode import _pick_cdef

        st, damp = _pick_cdef(pl, ours, blocks, qi, 8, (h, w))
        if any(st):
            cdef_frame(ours, blocks, st, damp, 8)
        for i in range(3):
            np.testing.assert_array_equal(
                planes[i], ours[i][:h, :w], err_msg=f"{name} plane {i}")

"""CDEF conformance: streams signaling CDEF must decode through the
independent dav1d decoder bit-exactly against our filtered reconstruction
(the semantics — per-plane direction gating, variance-scaled luma primary,
skip rules, boundary handling — were pinned with randomized probes; these
fixed cases guard them). SURVEY.md §2b N1 (libaom applies CDEF in every
lossy encode)."""

import numpy as np
import pytest

from oavif_jax.av1.cdef import cdef_frame
from oavif_jax.av1.encode import _filter_level
from oavif_jax.av1.frame import encode_frame_planes
from oavif_jax.av1.loopfilter import loop_filter_frame
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import (
    FrameConfig,
    SequenceConfig,
    assemble_av1_stream,
)
from oavif_jax.av1.yuv import rgb_to_yuv444


def _roundtrip(img8, qindex, strengths, damping, bd=8):
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    h, w = img8.shape[:2]
    if bd == 10:
        rgb = ((img8.astype(np.uint32) * 1023 + 127) // 255).astype(np.uint16)
    else:
        rgb = img8
    planes = rgb_to_yuv444(rgb, bitdepth=bd)
    payloads, recon, blocks = encode_frame_planes(planes, qindex,
                                                  bitdepth=bd, speed=9)
    flv = _filter_level(qindex)
    if flv:
        loop_filter_frame(recon, blocks, (flv,) * 4, bitdepth=bd,
                          visible=(h, w))
    cdef_frame(recon, blocks, strengths, damping, bd)
    recon = [p[:h, :w] for p in recon]
    seq = SequenceConfig(width=w, height=h, bit_depth=bd, enable_cdef=True)
    frame = FrameConfig(
        width=w, height=h, base_q_idx=qindex, filter_levels=(flv,) * 4,
        enable_cdef=True, cdef_damping=damping, cdef_strengths=(strengths,),
    )
    av1 = assemble_av1_stream(seq, frame, payloads)
    avif = mux_avif(av1, w, h, bit_depth=bd, high_bitdepth=bd == 10,
                    cicp=(2, 2, 2), icc=None)
    dec, depth, _ = decode_to_yuv(avif)
    for i, (a, b) in enumerate(zip(dec, recon)):
        np.testing.assert_array_equal(
            np.asarray(a, np.int64), np.asarray(b, np.int64),
            err_msg=f"plane {i} strengths={strengths}",
        )


def _img(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "texture":
        return np.clip(
            np.stack([128 + 100 * np.sin(xx / 15), 120 + 80 * np.cos(yy / 11),
                      100 + 90 * np.sin((xx + yy) / 23)], -1)
            + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "grad":
        return np.clip(np.stack([xx * 255 / w, yy * 255 / h,
                                 (xx + yy) * 127 / (w + h)], -1),
                       0, 255).astype(np.uint8)
    img = np.full((h, w, 3), 128, np.uint8)  # mostly-skip content
    img[h // 3:2 * h // 3, w // 3:2 * w // 3] = rng.integers(
        0, 256, (2 * h // 3 - h // 3, 2 * w // 3 - w // 3, 3))
    return img


# primary-only, secondary-only, both, strong/odd strengths, sec == 4,
# non-multiple-of-8 sizes (padding semantics), all-skip regions, 10-bit
@pytest.mark.parametrize("kind,h,w,qindex,strengths,damping,bd", [
    ("texture", 128, 128, 100, (2, 0, 0, 0), 3, 8),
    ("texture", 128, 128, 100, (0, 2, 0, 0), 3, 8),   # dir = 0 path
    ("texture", 128, 128, 100, (4, 2, 4, 2), 3, 8),
    ("noise", 160, 192, 120, (8, 4, 8, 2), 5, 8),
    ("grad", 76, 100, 100, (4, 2, 4, 2), 3, 8),       # padding reads
    ("grad", 135, 183, 171, (0, 2, 3, 4), 6, 8),      # luma dir 0, uv dir
    ("grad", 42, 154, 137, (5, 1, 0, 2), 4, 10),      # uv dir 0, 10-bit
    ("skipmix", 89, 69, 53, (6, 1, 7, 2), 6, 8),      # all-skip units
    ("texture", 120, 67, 175, (9, 4, 7, 0), 3, 10),   # mi%8==6 splits
])
def test_cdef_stream_decodes_bit_exact(kind, h, w, qindex, strengths,
                                       damping, bd):
    _roundtrip(_img(kind, h, w, 7), qindex, strengths, damping, bd)


def test_cdef_c_matches_python():
    """The C fast path and the Python reference produce identical planes."""
    import oavif_jax.av1.entropy.fast as fast

    rng = np.random.default_rng(3)
    for _ in range(4):
        ph = int(rng.integers(5, 20)) * 8
        pw = int(rng.integers(5, 20)) * 8
        planes = [rng.integers(0, 1024, (ph, pw)).astype(np.int32)
                  for _ in range(3)]
        blocks = [(r, c, 32, int(rng.integers(0, 2)))
                  for r in range(0, ph // 4, 8) for c in range(0, pw // 4, 8)]
        st = (int(rng.integers(0, 16)), int(rng.choice([0, 1, 2, 4])),
              int(rng.integers(0, 16)), int(rng.choice([0, 1, 2, 4])))
        damping = int(rng.integers(3, 7))
        a = [p.copy() for p in planes]
        b = [p.copy() for p in planes]
        assert fast.cdef_frame_native(a, blocks, st, damping, 10)
        orig = fast.cdef_frame_native
        fast.cdef_frame_native = lambda *args: False
        try:
            cdef_frame(b, blocks, st, damping, 10)
        finally:
            fast.cdef_frame_native = orig
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_cdef_search_prefers_off_on_noise_and_on_for_gradients():
    """The encoder-side SSE search matches the perceptual preference:
    off for pure noise (filtering destroys real detail), on for smooth
    gradients at coarse quantization (removes ringing)."""
    from oavif_jax.av1.encode import _pick_cdef

    h = w = 128
    for kind, expect_on in (("noise", False), ("grad", True)):
        img = _img(kind, h, w, 5)
        planes = rgb_to_yuv444(img)
        qindex = 140
        _, recon, blocks = encode_frame_planes(planes, qindex, 8, 9)
        flv = _filter_level(qindex)
        if flv:
            loop_filter_frame(recon, blocks, (flv,) * 4, bitdepth=8,
                              visible=(h, w))
        st, _ = _pick_cdef(planes, recon, blocks, qindex, 8, (h, w))
        assert any(st) == expect_on, (kind, st)


def test_product_path_cdef_on_recon_matches_decoder():
    """Full encode_avif_with_recon on gradient content (where the search
    enables CDEF): the returned recon must equal the independent decoder's
    output (the in-loop scoring contract)."""
    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.backend import EncCtx
    from oavif_jax.io.avif_ctypes import decode_to_yuv
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions

    h = w = 192
    img = _img("grad", h, w, 9)
    src = Image(width=w, height=h, channels=3, hbd=False, data=img)
    ctx = EncCtx(o=EncOptions(tenbit=False), src=src, rgb=img,
                 w=w, h=h, q=55)
    data, recon_rgb = encode_avif_with_recon(ctx)
    # confirm the stream really signals CDEF with nonzero strengths
    from oavif_jax.av1.frame import encode_frame_planes
    from oavif_jax.av1.loopfilter import loop_filter_frame
    from oavif_jax.av1.encode import _filter_level, _pick_cdef
    from oavif_jax.av1.consts import quality_to_qindex
    from oavif_jax.av1.yuv import rgb_to_yuv444, yuv444_to_rgb

    qi = quality_to_qindex(55)
    pl = rgb_to_yuv444(img)
    _, rec, blocks = encode_frame_planes(pl, qi, 8, 9)
    flv = _filter_level(qi)
    if flv:
        loop_filter_frame(rec, blocks, (flv,) * 4, bitdepth=8,
                          visible=(h, w))
    st, _ = _pick_cdef(pl, rec, blocks, qi, 8, (h, w))
    assert any(st), "expected the search to enable CDEF on gradients"
    yuv, depth, _ = decode_to_yuv(data)
    dec_rgb = yuv444_to_rgb([np.asarray(p, np.int32) for p in yuv],
                            bitdepth=depth)
    np.testing.assert_array_equal(dec_rgb, recon_rgb)

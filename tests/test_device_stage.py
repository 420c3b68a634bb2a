"""Batched device encode stage (device_stage.py): numerics vs a host
recompute, conformance of consumed streams, and the q-batch axis."""
import os

import numpy as np
import pytest


def _fractal(h, w, seed=7):
    rng = np.random.default_rng(seed)
    f = (np.fft.fftfreq(h)[:, None] ** 2
         + np.fft.fftfreq(w)[None, :] ** 2)
    spec = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) \
        / np.maximum(f, 1e-6) ** 0.5
    tex = np.real(np.fft.ifft2(spec))
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    return np.clip(
        np.stack([40 + 180 * tex, 30 + 190 * tex ** 1.2,
                  60 + 160 * tex ** 0.8], -1), 0, 255,
    ).astype(np.uint8)


def test_device_levels_match_host_quantize():
    """Interior planned blocks' device levels equal a float64 host
    recompute of the same open-loop round-half quantization (up to the
    f32-vs-f64 coefficient rounding at exact .5 boundaries)."""
    from oavif_jax.av1.frame import _attach_device_levels, _get_planner
    from oavif_jax.av1.intra import build_edges, predict
    from oavif_jax.av1.tables import ac_q, dc_q
    from oavif_jax.av1.transform import fwd_matrices
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rgb = _fractal(256, 256)
    pl = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    planner = _get_planner(pl, 8, 13, 0, 0)
    plan = planner.plan(40)
    assert plan is not None
    _attach_device_levels(planner, plan, 40, 8)
    lv, mask, m16 = plan["lv16"], plan["lv16_mask"], plan["mode16"]
    fh, fw = fwd_matrices(16, 16, "dct_dct")
    dqd, dqa = float(dc_q(40, 8)), float(ac_q(40, 8))
    y = pl[0]
    checked = 0
    for i in range(mask.shape[0]):
        for j in range(mask.shape[1]):
            if not mask[i, j]:
                continue
            x0, y0 = j * 16, i * 16
            mode = int(m16[i, j]) & 0xFF
            a, l = build_edges(y, x0, y0, 16, 16, True, True, 8)
            pred = predict(mode, a, l, 16, 16, True, True, bitdepth=8)
            resid = (y[y0:y0 + 16, x0:x0 + 16] - pred).astype(np.float64)
            cf = (fh @ resid @ fw.T).reshape(-1)
            dq = np.full(256, dqa)
            dq[0] = dqd
            mag = np.floor(np.abs(cf) / dq + 0.5)
            ref = np.where(cf < 0, -mag, mag).astype(np.int64)
            d = np.abs(ref - lv[i, j].astype(np.int64))
            assert d.max() <= 1 and (d > 0).sum() <= 4, (i, j, mode)
            checked += 1
    assert checked > 50


def test_device_levels_stream_conformance(monkeypatch):
    """A stream that CONSUMED device levels still decodes bit-exactly to
    the encoder's reconstruction (the levels are encoder freedom; recon
    uses the exact integer dequant+inverse either way)."""
    monkeypatch.setenv("OAVIF_PY_TILE", "1")
    monkeypatch.setenv("OAVIF_DEVICE_LEVELS", "1")
    monkeypatch.setenv("OAVIF_DEC_REUSE", "0")
    import oavif_jax.av1.frame as F
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig, SequenceConfig, assemble_av1_stream,
    )
    from oavif_jax.av1.yuv import rgb_to_yuv444
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    rgb = _fractal(256, 256, seed=11)
    h, w = rgb.shape[:2]
    pl = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]

    consumed = [0]
    orig = F.TileEncoder._encode_block

    def counting(self, r, c, size):
        if (size == 16 and self.plan is not None
                and self.plan.get("lv16") is not None):
            i16, j16 = r // 4, c // 4
            mm = self.plan["lv16_mask"]
            if (i16 < mm.shape[0] and j16 < mm.shape[1]
                    and mm[i16, j16]):
                consumed[0] += 1
        return orig(self, r, c, size)

    monkeypatch.setattr(F.TileEncoder, "_encode_block", counting)
    payload, recon, blocks = F._encode_one_tile((pl, 40, 8, 9, True, 0, 0))
    assert consumed[0] > 0, "device levels should reach the coder"
    seq = SequenceConfig(width=w, height=h, bit_depth=8)
    frame = FrameConfig(width=w, height=h, base_q_idx=40)
    avif = mux_avif(assemble_av1_stream(seq, frame, [payload]), w, h,
                    bit_depth=8, high_bitdepth=False, cicp=(2, 2, 2))
    yuv, _, _ = decode_to_yuv(avif)
    for pi, (ours, dec) in enumerate(zip(recon, yuv)):
        np.testing.assert_array_equal(ours[:h, :w], dec, err_msg=str(pi))


def test_device_levels_q_batch():
    """The q-batch axis (batched speculative TQ, BASELINE config 2): one
    call returns per-quantizer levels; each slice equals the single-q
    result."""
    from oavif_jax.av1.device_stage import DeviceLevels
    from oavif_jax.av1.frame import _get_planner
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rgb = _fractal(256, 256, seed=13)
    pl = [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]
    planner = _get_planner(pl, 8, 13, 0, 0)
    assert planner.dev is not None
    dl = DeviceLevels(planner, 8)
    modes = np.zeros((planner.psby * 4, planner.psbx * 4), np.int32)
    lv_b, eob_b = dl.levels(modes, [30, 60, 90])
    assert lv_b.shape[0] == 3 and eob_b.shape[0] == 3
    for k, q in enumerate([30, 60, 90]):
        lv_1, eob_1 = dl.levels(modes, [q])
        np.testing.assert_array_equal(lv_b[k], lv_1[0])
        np.testing.assert_array_equal(eob_b[k], eob_1[0])
    # coarser quantizers keep (weakly) fewer coefficients
    assert int(eob_b[2].sum()) <= int(eob_b[0].sum())

"""Cross-probe decision reuse (record/replay) correctness.

The TQ loop re-encodes the same image at nearby quantizers; the C and
Python tile encoders record per-block RD decisions (tx depth, tx types,
chroma mode/alphas) on the first planned encode and replay them on later
probes within the plan-reuse window. These tests pin:
  - C and Python replay paths stay byte-identical,
  - replay is deterministic,
  - replayed streams still decode bit-exactly (YUV) via the independent
    oracle decoder,
  - the byte cost of replay stays small.
"""

import os

import numpy as np
import pytest

from oavif_jax.av1 import frame as F
from oavif_jax.av1.yuv import rgb_to_yuv444


@pytest.fixture
def planes(test_rgb8):
    # a 256x256 crop is above the planner size gate (256*256)
    rng = np.random.default_rng(9)
    img = np.clip(
        np.kron(rng.integers(40, 215, (32, 32, 3)), np.ones((8, 8, 1)))
        + rng.normal(0, 5, (256, 256, 3)),
        0,
        255,
    ).astype(np.uint8)
    return [np.asarray(p, dtype=np.int32) for p in rgb_to_yuv444(img, 8)]


def _enc(planes, q, py=False):
    if py:
        os.environ["OAVIF_PY_TILE"] = "1"
    else:
        os.environ.pop("OAVIF_PY_TILE", None)
    try:
        p, r, b = F.encode_frame_planes(
            planes, q, 8, 9, use_device_planner=True, u_ac_delta_q=32
        )
    finally:
        os.environ.pop("OAVIF_PY_TILE", None)
    return p[0], r


def _reset():
    F._DEC_CACHE.clear()
    F._PLANNER_CACHE.clear()


def test_replay_c_py_parity(planes):
    from oavif_jax.av1.entropy.fast import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    _reset()
    c_rec, _ = _enc(planes, 40)
    c_rep, _ = _enc(planes, 44)
    _reset()
    p_rec, _ = _enc(planes, 40, py=True)
    p_rep, _ = _enc(planes, 44, py=True)
    assert c_rec == p_rec, "record-mode bytes diverge C vs Python"
    assert c_rep == p_rep, "replay-mode bytes diverge C vs Python"


def test_replay_deterministic_and_conformant(planes):
    from oavif_jax.av1.mux import mux_avif
    from oavif_jax.av1.obu import (
        FrameConfig,
        SequenceConfig,
        assemble_av1_stream,
    )
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    _reset()
    _enc(planes, 40)
    rep1, recon1 = _enc(planes, 44)
    rep2, recon2 = _enc(planes, 44)
    assert rep1 == rep2

    h, w = planes[0].shape
    seq = SequenceConfig(width=w, height=h, bit_depth=8)
    frame = FrameConfig(width=w, height=h, base_q_idx=44, u_ac_delta_q=32)
    av1 = assemble_av1_stream(seq, frame, [rep1])
    avif = mux_avif(av1, w, h, bit_depth=8, high_bitdepth=False,
                    cicp=(2, 2, 2))
    yuv, bd, rng_flag = decode_to_yuv(avif)
    for ours, dec in zip(recon1, yuv):
        np.testing.assert_array_equal(ours[:h, :w], dec)


def test_replay_byte_cost_small(planes):
    _reset()
    _enc(planes, 40)
    rep, _ = _enc(planes, 48)
    _reset()
    os.environ["OAVIF_DEC_REUSE"] = "0"
    try:
        fresh, _ = _enc(planes, 48)
    finally:
        os.environ.pop("OAVIF_DEC_REUSE")
    assert len(rep) <= len(fresh) * 1.03, (len(rep), len(fresh))


@pytest.mark.parametrize("speed", [4, 5, 6, 7, 8, 9, 10])
def test_speed_ladder_c_py_parity(planes, speed):
    """Every speed preset's knob set must stay byte-identical between the
    C and Python encoders (the ladder touches ADST gates, split trials,
    RDOQ, CfL breadth, and decision reuse)."""
    from oavif_jax.av1.entropy.fast import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    _reset()
    os.environ.pop("OAVIF_PY_TILE", None)
    c_p, _, _ = F.encode_frame_planes(planes, 40, 8, speed,
                                      use_device_planner=True, u_ac_delta_q=32)
    _reset()
    os.environ["OAVIF_PY_TILE"] = "1"
    try:
        p_p, _, _ = F.encode_frame_planes(planes, 40, 8, speed,
                                          use_device_planner=True,
                                          u_ac_delta_q=32)
    finally:
        os.environ.pop("OAVIF_PY_TILE", None)
    assert c_p[0] == p_p[0], f"speed {speed} bytes diverge C vs Python"

"""The device planner's contracts on the CPU backend: its directional
predictions equal the host predictor, a planner failure is not hidden,
and the round-robin placement of tile planners over several devices
leaves the bytes unchanged."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oavif_jax.av1 import device_plan as DP
from oavif_jax.av1 import frame as FR
from oavif_jax.av1.intra import build_edges, predict


@pytest.mark.parametrize("k", range(len(DP._DIR_ANGLES)))
def test_directional_modes_equal_host_predict(k):
    """_predict_directional_modes (whichever formulation the planner
    uses) equals the spec predictor on interior 16x16 blocks, whose
    source edges the device and host build alike (above-right and
    below-left replicated from the last sample)."""
    rng = np.random.default_rng(40 + k)
    y = rng.integers(0, 1024, (128, 128)).astype(np.int32)
    fp = DP.FramePlanner([y, y, y], 10)
    p = jnp.asarray(fp.dev[0]).astype(jnp.float32)
    nb = 128 // 16
    _, above, left, corner = DP._grid_edges(
        p[: 128 + 1, : 128 + 1], nb, nb, 16, 512.0)
    got = np.asarray(DP._predict_directional_modes(above, left, corner, 16))
    mode = int(DP.MODE_IDS[DP.N_MODES + k])
    for i in range(1, nb):
        for j in range(1, nb):
            a, l = build_edges(y, j * 16, i * 16, 16, 16, True, True, 10)
            want = predict(mode, a, l, 16, 16, True, True, bitdepth=10)
            np.testing.assert_array_equal(
                got[i * nb + j, k], want, err_msg=f"block {i},{j}")


def _fractal_planes(h, w, seed=3):
    import bench
    from oavif_jax.av1.yuv import rgb_to_yuv444

    rgb = bench._img_fractal(h, w, seed=seed)
    return [p.astype(np.int32) for p in rgb_to_yuv444(rgb, 8)]


def test_planner_error_propagates(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planner failed")

    monkeypatch.setattr(FR, "_get_planner", broken)
    planes = _fractal_planes(256, 256)
    with pytest.raises(RuntimeError, match="planner failed"):
        FR._encode_one_tile((planes, 60, 8, 9, True, 0, 0))


def test_round_robin_tile_planners_keep_bytes():
    """Four tiles over four (virtual) devices, one planner each, give
    the bytes of every planner on one device."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 devices")
    planes = _fractal_planes(256, 1024)
    out = {}
    for n in (4, 1):
        FR._PLANNER_CACHE.clear()
        FR._DEC_CACHE.clear()
        with mock.patch.object(jax, "devices", lambda *a: devs[:n]):
            payloads, recon, _ = FR.encode_frame_planes(
                [p.copy() for p in planes], 60, 8, speed=9,
                tile_cols_log2=2, use_device_planner=True,
                u_ac_delta_q=16)
        placed = {d for fp in FR._PLANNER_CACHE.values()
                  for a in fp.dev for d in a.devices()}
        assert len(payloads) == 4 and len(placed) == n
        out[n] = (payloads, recon)
    FR._PLANNER_CACHE.clear()
    assert out[4][0] == out[1][0]
    for a, b in zip(out[4][1], out[1][1]):
        np.testing.assert_array_equal(a, b)

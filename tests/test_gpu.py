"""Checks that need the card: the device steps on the GPU against their
references. They skip without a GPU; on the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

chip_smoke.py runs the same checks at full size (its phases b, c, f)."""

import jax
import pytest

import bench
import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", ["fractal", "edges", "text"])
def test_planner_gpu_equals_cpu_backend(gpu_device, name):
    planes = chip_smoke.yuv_planes(bench.corpus(512)[name], 10)
    rows = chip_smoke.plan_mismatches(
        planes, 10, (gpu_device, jax.devices("cpu")[0]))
    assert all(not any(m.values()) for _, _, m in rows), rows


@pytest.mark.parametrize("name", ["sinusoid", "edges", "mixed"])
def test_metric_gpu_matches_c(gpu_device, name):
    from oavif_jax.metric import compute_ssimulacra2

    img = bench.corpus(512)[name]
    assert abs(compute_ssimulacra2(img, img) - 100.0) < 1e-3
    for jx, c in chip_smoke.metric_deltas(
            img, chip_smoke.distortions(img, 3)):
        assert abs(jx - c) < 0.05, (jx, c)


def test_device_levels_gpu_match_host(gpu_device):
    checked, worst, worst_n = chip_smoke.device_level_errors(
        bench.corpus(512)["fractal"], 40)
    assert checked > 50 and worst <= 1 and worst_n <= 4, (
        checked, worst, worst_n)

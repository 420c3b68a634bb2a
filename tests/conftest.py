"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tile-sharding logic is exercised on host-platform virtual devices per
SURVEY.md §4(d). JAX_PLATFORMS defaults to the CPU; an explicit value is
kept, so ``JAX_PLATFORMS=cuda,cpu`` runs the ``gpu``-marked tests on the
card (they compare it with the CPU backend in the same process).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided here, never at
    import: the xdist workers must all collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def test_rgb8(rng):
    """A 128x96 synthetic photo-like RGB8 image: gradients + texture."""
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    g = 120 + 80 * np.cos(xx / 29.0 + 1.0) + 20 * np.sin(yy / 7.0)
    b = 100 + 90 * np.sin((xx + yy) / 31.0)
    img = np.stack([r, g, b], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)

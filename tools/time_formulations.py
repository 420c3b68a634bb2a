#!/usr/bin/env python3
"""Time the planner's and device stage's formulations against their plain
alternatives on the GPU, and check that each pair gives identical output.

    python tools/time_formulations.py

  - directional intra prediction: the two-tap gather the planner ships
    (device_plan._predict_directional_modes) against the dense
    (n, 66) x (66, 1536) matmul with the equivalent weight matrix;
  - the eob scan of the device stage: the static index it ships
    (device_stage._quant_body) against a 256x256 permutation matmul.

Each is timed alone and inside its whole jitted step, at the 512²
corpus shape and at a 12 MP photo tile (1536x4032, bucketed to 4096),
as the median of repeated calls that end in block_until_ready. Prints
the card's name and power limit first; needs a GPU.
"""

from __future__ import annotations

import functools
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPS = 30


def timeit(fn, *args):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


@functools.lru_cache(maxsize=None)
def _dir_weights(n_px: int) -> np.ndarray:
    """The (2(2P+1), 6P²) matrix holding device_plan._dir_taps."""
    from oavif_jax.av1.device_plan import _dir_taps

    i0, w0, i1, w1 = _dir_taps(n_px)
    W = np.zeros((2 * (2 * n_px + 1), i0.size), np.float32)
    cols = np.arange(i0.size)
    np.add.at(W, (i0, cols), w0)
    np.add.at(W, (i1, cols), w1)
    return W


def matmul_directional(above, left, corner, n_px: int):
    """The dense-matmul form of device_plan._predict_directional_modes."""
    import jax
    import jax.numpy as jnp

    from oavif_jax.av1.device_plan import _DIR_ANGLES

    n, P = above.shape[0], n_px
    aE = jnp.concatenate([above, jnp.broadcast_to(above[:, -1:], (n, P))], 1)
    lE = jnp.concatenate([left, jnp.broadcast_to(left[:, -1:], (n, P))], 1)
    E = jnp.concatenate([corner[:, None], aE, corner[:, None], lE], 1)
    v = jnp.floor((jnp.dot(E, _dir_weights(P),
                           precision=jax.lax.Precision.HIGHEST) + 16.0) / 32.0)
    return v.reshape(n, len(_DIR_ANGLES), P, P)


def perm_eob(lv):
    """The permutation-matmul form of device_stage's eob scan."""
    import jax.numpy as jnp

    from oavif_jax.av1.tables import TABLES

    p = np.zeros((256, 256), np.float32)
    p[np.arange(256), np.asarray(TABLES["scan_16x16"])] = 1.0
    sc_nz = (jnp.abs(lv) @ p.T > 0).astype(jnp.int32)
    idx = jnp.arange(1, 257, dtype=jnp.int32)[None, :]
    return jnp.max(sc_nz * idx, axis=1)


def index_eob(lv):
    import jax.numpy as jnp

    from oavif_jax.av1.device_stage import _scan16

    sc_nz = (lv[:, _scan16()] != 0).astype(jnp.int32)
    idx = jnp.arange(1, 257, dtype=jnp.int32)[None, :]
    return jnp.max(sc_nz * idx, axis=1)


def main() -> int:
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke
    from oavif_jax.av1 import device_plan as DP
    from oavif_jax.av1 import device_stage as DS
    from oavif_jax.av1.tables import ac_q
    from oavif_jax.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    gpu = require_gpu()
    print(chip_smoke.nvidia_smi())
    print(f"{gpu.device_kind}; median of {REPS} calls, ms")
    photo = bench._img_fractal(*chip_smoke.PHOTO_HW, seed=5)
    shapes = {
        "512": chip_smoke.yuv_planes(bench.corpus(512)["fractal"], 10),
        "12MP tile": chip_smoke.tile_planes(
            chip_smoke.yuv_planes(photo, 10))[0],
    }
    product = DP._predict_directional_modes
    for name, planes in shapes.items():
        fp = DP.FramePlanner(planes, 10)
        nby, nbx = fp.psby * 2, fp.psbx * 2
        args = (*fp.dev, jnp.float32(ac_q(40, 10)), jnp.float32(40))
        steps = {}
        for form, fn in (("gather", product), ("matmul", matmul_directional)):
            DP._predict_directional_modes = fn
            try:
                step = jax.jit(functools.partial(
                    DP._plan_device_body, nby=nby, nbx=nbx, bitdepth=10,
                    nmodes=13, duel_level=0))
                steps[form] = (step, np.asarray(step(*args)))
            finally:
                DP._predict_directional_modes = product
        assert np.array_equal(steps["gather"][1], steps["matmul"][1])
        p = fp.dev[0].astype(jnp.float32)
        _, above, left, corner = DP._grid_edges(p, nby * 2, nbx * 2, 16,
                                                jnp.float32(512))
        alone = {
            "gather": jax.jit(functools.partial(product, n_px=16)),
            "matmul": jax.jit(functools.partial(matmul_directional,
                                                n_px=16)),
        }
        a, b = (np.asarray(f(above, left, corner)) for f in alone.values())
        assert np.array_equal(a, b)
        for form in ("gather", "matmul"):
            print(f"directional {form:6s} {name:9s}: alone "
                  f"{timeit(alone[form], above, left, corner):.3f}, "
                  f"planner step {timeit(steps[form][0], *args):.3f}")

        modes = jnp.zeros((nby * 2, nbx * 2), jnp.int32)
        coeffs = DS._coeffs_jit(fp.dev[0], nby * 2, nbx * 2, modes, 10)
        lv = jnp.round(coeffs.reshape(-1, 256) / 40.0)
        forms = {"index": jax.jit(index_eob), "perm": jax.jit(perm_eob)}
        assert np.array_equal(np.asarray(forms["index"](lv)),
                              np.asarray(forms["perm"](lv)))
        for form, fn in forms.items():
            print(f"eob scan    {form:6s} {name:9s}: alone "
                  f"{timeit(fn, lv):.3f} ({lv.shape[0]} blocks)")
        dq = jnp.asarray([40.0], jnp.float32)
        print(f"quant step  index  {name:9s}: "
              f"{timeit(DS._quant_batch, coeffs, dq, dq, 0):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

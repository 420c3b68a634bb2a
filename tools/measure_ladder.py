"""Measure the speed ladder: wall / bytes / score per speed preset
(single 512x512 fractal probe at fixed q, planner on, fresh caches).
Produces the README ladder table.

    python tools/measure_ladder.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")


def main():
    import jax

    if os.environ.get("LADDER_DEVICE") != "1":
        jax.config.update("jax_platforms", "cpu")
    import bench
    from oavif_jax.av1 import frame as F
    from oavif_jax.av1.yuv import rgb_to_yuv444, yuv444_to_rgb
    from oavif_jax.metric.native import compute_ssimulacra2_native

    img = bench._img_fractal(512, 512)
    planes = rgb_to_yuv444(img, bitdepth=8)
    h, w = planes[0].shape
    q = 36

    print(f"{'speed':>5s} {'wall ms':>8s} {'bytes':>8s} {'score':>7s}")
    rows = []
    for speed in (10, 9, 8, 7, 6, 5, 4, 2):
        F._DEC_CACHE.clear()
        F._PLANNER_CACHE.clear()
        best = None
        for _ in range(3):
            F._DEC_CACHE.clear()
            p, r, b = F.encode_frame_planes(
                planes, q, 8, speed, use_device_planner=True, u_ac_delta_q=32
            )
            t0 = time.perf_counter()
            F._DEC_CACHE.clear()
            p, r, b = F.encode_frame_planes(
                planes, q, 8, speed, use_device_planner=True, u_ac_delta_q=32
            )
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, p, r)
        dt, p, r = best
        rec = yuv444_to_rgb([x[:h, :w] for x in r], bitdepth=8)
        s = compute_ssimulacra2_native(img, rec)
        rows.append((speed, dt * 1000, len(p[0]), s))
        print(f"{speed:5d} {dt*1000:8.0f} {len(p[0]):8d} {s:7.2f}")


if __name__ == "__main__":
    main()

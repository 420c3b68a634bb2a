"""Quantify the cross-probe approximations (VERDICT r2 #8).

Two approximations trade quality for probe speed:
  1. plan cache: a device plan computed at q0 is reused for any probe
     within +-16 qindex on the same side of the q=90 gate;
  2. decision reuse: per-block tx/chroma RD choices recorded at q0 are
     replayed at nearby q.

This script measures their combined cost: encode at qf fresh (exact plan,
no reuse) vs through the window (plan+decisions from q0 = qf - dq),
reporting bytes and SSIMULACRA2 deltas. Results go into PARITY.md.

    python tools/measure_reuse_cost.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")


def main():
    import jax

    if os.environ.get("REUSE_COST_DEVICE") != "1":
        jax.config.update("jax_platforms", "cpu")
    import bench
    from oavif_jax.av1 import encode as E
    from oavif_jax.av1 import frame as F
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.metric.native import compute_ssimulacra2_native

    enc = OavifBackend()
    images = {
        "sinusoid": bench._img_sinusoid(512, 512),
        "fractal": bench._img_fractal(512, 512),
        "edges": bench._img_edges(512, 512),
    }
    print(f"{'image':10s} {'qf':>3s} {'dq':>3s} {'fresh B':>8s} {'reuse B':>8s} "
          f"{'dB%':>6s} {'fresh S':>8s} {'reuse S':>8s} {'dS':>6s}")
    worst_b, worst_s = 0.0, 0.0
    for name, img in images.items():
        for qf in (86, 92):
            ctx = bench._make_ctx(img)
            for dq in (4, 8, 16):
                q0 = qf - dq
                # fresh at qf
                F._DEC_CACHE.clear()
                F._PLANNER_CACHE.clear()
                E._SRC_CACHE.clear()
                ctx.q = qf
                fresh, rec_f = enc.encode_with_recon(ctx)
                s_f = compute_ssimulacra2_native(img, rec_f)
                # windowed: seed the caches at q0, then encode at qf
                F._DEC_CACHE.clear()
                F._PLANNER_CACHE.clear()
                ctx.q = q0
                enc.encode_with_recon(ctx)
                ctx.q = qf
                reuse, rec_r = enc.encode_with_recon(ctx)
                s_r = compute_ssimulacra2_native(img, rec_r)
                db = 100.0 * (len(reuse) - len(fresh)) / len(fresh)
                ds = s_r - s_f
                worst_b = max(worst_b, abs(db))
                worst_s = max(worst_s, abs(ds))
                print(f"{name:10s} {qf:3d} {dq:3d} {len(fresh):8d} "
                      f"{len(reuse):8d} {db:+6.2f} {s_f:8.2f} {s_r:8.2f} "
                      f"{ds:+6.2f}")
    print(f"\nworst |bytes delta| {worst_b:.2f}%  worst |score delta| "
          f"{worst_s:.2f}")


if __name__ == "__main__":
    main()

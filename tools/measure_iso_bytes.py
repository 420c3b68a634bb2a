"""Bytes at iso-SSIMULACRA2 score vs the libaom stack (oracle backend).

For each bench corpus class: run the product search to target 80 with a
tight tolerance, then log-interpolate the oracle's bytes on its own
(q, bytes, score) curve AT OUR ACHIEVED SCORE. Both sides score through
the same from-scratch SSIMULACRA2 (metric/ssimu2.c), so the comparison
is symmetric in the metric. Appends nothing; prints a CSV-ish table
(recorded runs live in benchmarks/iso_score_bytes_r*.csv).

Run: python tools/measure_iso_bytes.py
"""

from __future__ import annotations

import math
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")


def main():
    import importlib.util

    import numpy as np  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        "benchmod", str(Path(__file__).resolve().parent.parent / "bench.py"))
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    from oavif_jax.backend import EncCtx
    from oavif_jax.backend.oracle import OracleBackend
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.io.image import Image
    from oavif_jax.metric.native import compute_ssimulacra2_native as score_fn
    from oavif_jax.options import EncOptions
    from oavif_jax.tq.driver import search_encode

    enc, orc = OavifBackend(), OracleBackend()

    def mk(img, **kw):
        h, w = img.shape[:2]
        return EncCtx(o=EncOptions(speed=9, **kw),
                      src=Image(width=w, height=h, channels=3, hbd=False,
                                data=img),
                      rgb=img, w=w, h=h)

    logs = []
    print(f"{'class':10s} {'ours_B':>8s} {'ours_s':>7s} {'aom_B@s':>9s} "
          f"{'ratio':>6s}")
    for name in ["sinusoid", "fractal", "edges", "oriented", "text",
                 "mixed"]:
        img = getattr(bm, "_img_" + name)(512, 512)
        r, data = search_encode(
            mk(img, score_tgt=80.0, tolerance=0.5, max_pass=8), enc)
        by_o, sc_o = len(data), r.score

        pts = {}

        def oprobe(q):
            if q in pts:
                return pts[q]
            c = mk(img)
            c.q = q
            d = orc.encode(c)
            s = score_fn(img, orc.decode_to_rgb8(d))
            pts[q] = (s, len(d))
            return pts[q]

        for q in (55, 65, 75, 82, 88, 93, 97):
            oprobe(q)
        for _ in range(6):
            items = sorted(pts.items())
            below = [(q, v) for q, v in items if v[0] <= sc_o]
            above = [(q, v) for q, v in items if v[0] > sc_o]
            if not below or not above:
                break
            qb = max(below)[0]
            qa = min(q for q, v in above)
            if qa - qb <= 1:
                break
            oprobe((qa + qb) // 2)
        items = sorted(pts.items())
        below = [(q, v) for q, v in items if v[0] <= sc_o]
        above = [(q, v) for q, v in items if v[0] > sc_o]
        if below and above:
            (q0, (s0, b0)) = max(below)
            (q1, (s1, b1)) = min(above, key=lambda t: t[0])
            t = (sc_o - s0) / (s1 - s0) if s1 != s0 else 0.0
            b_at = math.exp(math.log(b0) * (1 - t) + math.log(b1) * t)
        else:
            b_at = float("nan")
        ratio = by_o / b_at
        logs.append(math.log(ratio))
        print(f"{name:10s} {by_o:8d} {sc_o:7.2f} {b_at:9.0f} {ratio:6.2f}")
    print(f"geomean ratio: {math.exp(sum(logs) / len(logs)):.3f}")


if __name__ == "__main__":
    main()

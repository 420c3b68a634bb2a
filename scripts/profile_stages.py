"""Per-stage wall-time breakdown of a TQ search encode (VERDICT r2 #1).

Wraps the hot stages with timers and runs the bench corpus through
search_encode on the default backend, printing ms per stage per image.
Usage:  python scripts/profile_stages.py [size]
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ACC = defaultdict(float)
CNT = defaultdict(int)


def wrap(mod, name, label):
    fn = getattr(mod, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        ACC[label] += time.perf_counter() - t0
        CNT[label] += 1
        return out

    setattr(mod, name, timed)
    return fn


def wrap_method(cls, name, label):
    fn = getattr(cls, name)

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        out = fn(self, *a, **k)
        ACC[label] += time.perf_counter() - t0
        CNT[label] += 1
        return out

    setattr(cls, name, timed)


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    images = {
        "sinusoid": bench._img_sinusoid(size, size),
        "fractal": bench._img_fractal(size, size),
        "edges": bench._img_edges(size, size),
    }

    from oavif_jax.av1 import encode as enc_mod
    from oavif_jax.av1 import frame as frame_mod
    from oavif_jax.av1 import device_plan
    from oavif_jax.av1.entropy import fast as fast_mod
    from oavif_jax.av1 import obu as obu_mod
    from oavif_jax.av1 import mux as mux_mod
    from oavif_jax.metric import ssimulacra2 as met_mod
    from oavif_jax import tq

    wrap(enc_mod, "rgb_to_yuv444", "rgb->yuv")
    wrap(enc_mod, "yuv444_to_rgb", "yuv->rgb(recon)")
    wrap(enc_mod, "_chroma_delta_q", "chroma-dq-analysis")
    wrap(enc_mod, "loop_filter_frame", "loopfilter")
    wrap(enc_mod, "_pick_cdef", "cdef-search")
    wrap(enc_mod, "cdef_frame", "cdef-apply")
    wrap(enc_mod, "assemble_av1_stream", "obu-assemble")
    wrap(enc_mod, "mux_avif", "mux")
    wrap(frame_mod, "encode_frame_planes", "TOTAL-frame-encode")
    wrap(fast_mod, "tile_encode_native", "C-tile-encode")
    wrap_method(device_plan.FramePlanner, "plan", "planner.plan")
    wrap_method(device_plan.FramePlanner, "__init__", "planner.init(upload)")
    orig_batch = met_mod.compute_ssimulacra2_batch

    def timed_batch(*a, **k):
        t0 = time.perf_counter()
        out = orig_batch(*a, **k)
        ACC["metric-batch"] += time.perf_counter() - t0
        CNT["metric-batch"] += 1
        return out

    met_mod.compute_ssimulacra2_batch = timed_batch
    import oavif_jax.tq.driver as drv
    # driver imports the symbol inside the closure at call time
    # (from ..metric.ssimulacra2 import compute_ssimulacra2_batch)
    # so patch the module attr is enough.

    from oavif_jax.backend import EncCtx
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions
    from oavif_jax.tq.driver import search_encode

    backend = OavifBackend()

    def make_ctx(img):
        h, w = img.shape[:2]
        return EncCtx(
            o=EncOptions(speed=int(os.environ.get("PROF_SPEED", "9"))),
            src=Image(width=w, height=h, channels=3, hbd=False, data=img),
            rgb=img,
            w=w,
            h=h,
        )

    # warm: compile everything outside the profiled region
    warm = make_ctx(next(iter(images.values())))
    warm.o.max_pass = 1
    search_encode(warm, backend)
    for k in list(ACC):
        ACC[k] = 0.0
        CNT[k] = 0

    per_image = {}
    for name, img in images.items():
        before = dict(ACC)
        ctx = make_ctx(img)
        t0 = time.perf_counter()
        res, data = search_encode(ctx, backend)
        wall = time.perf_counter() - t0
        delta = {k: ACC[k] - before.get(k, 0.0) for k in ACC}
        per_image[name] = (wall, delta, res, len(data))

    print(f"\n=== per-stage breakdown ({size}x{size}, speed {os.environ.get('PROF_SPEED', '9')}) ===")
    for name, (wall, delta, res, nbytes) in per_image.items():
        print(f"\n[{name}] wall={wall*1000:.0f}ms q={res.q} score={res.score:.2f} bytes={nbytes}")
        known = 0.0
        for k in sorted(delta, key=lambda k: -delta[k]):
            if delta[k] < 0.0005:
                continue
            ind = "  " if k != "TOTAL-frame-encode" else ""
            print(f"  {ind}{k:24s} {delta[k]*1000:7.1f}ms")
            if k not in ("TOTAL-frame-encode",):
                known += delta[k]
        # frame-encode contains C-encode+planner; avoid double count:
        inner = delta.get("C-tile-encode", 0) + delta.get("planner.plan", 0) + delta.get("planner.init(upload)", 0)
        overhead_frame = delta.get("TOTAL-frame-encode", 0) - inner
        print(f"    {'frame-py-overhead':24s} {overhead_frame*1000:7.1f}ms")
        accounted = known - delta.get("TOTAL-frame-encode", 0) + delta.get("TOTAL-frame-encode", 0)
        print(f"    {'unaccounted':24s} {(wall - accounted)*1000:7.1f}ms")
    print("\ncall counts:", dict(CNT))


if __name__ == "__main__":
    main()

"""Round benchmark: MP/s at SSIMULACRA2 target 80 (tolerance 2).

Prints ONE JSON line {"metric","value","unit","vs_baseline"}.

ours      = oavif-jax: from-scratch AV1 encoder (native entropy/transform
            runtime) + device partition/mode planning; TQ scored on the
            encoder's own reconstruction (no decode round-trip). The
            corpus pipeline (tq/pipeline.py) scores probes on the GPU
            with the JAX metric while the host encodes other images,
            and inline with the C scorer (metric/ssimu2.c) where nothing
            else is left to overlap. Timed as full wall (encode + metric
            + search control). Needs a GPU: without one it exits
            non-zero rather than time the CPU.
baseline  = the reference's exact native stack (libaom via libavif encode +
            decode round-trip), the self-baseline BASELINE.md prescribes
            (the reference publishes no numbers). Its metric (fssimu2)
            is native and cheap in the reference, so the baseline timer
            covers ONLY encode+decode — the metric runs outside the timed
            region. That makes vs_baseline strictly conservative for us.
            One asymmetry the other way: ours encodes the 10-bit default
            config while the Pillow-driven oracle approximates it at
            8-bit (backend/oracle.py), which slightly flatters baseline
            SPEED (8-bit libaom encodes are cheaper) and is conservative
            against us on bytes.

Corpus: six 512x512 classes — sinusoid+noise ("photo"-smooth), 1/f
fractal texture (the photographic stand-in: natural spectral shape),
hard-edge synthetic, oriented texture (angled stripes — the content
directional intra + rect partitions exist for), text-on-gradient
(screen content), and mixed-scale structure (flat regions + detail
patches — partition adaptivity). No real photographs ship in this
offline environment.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _img_sinusoid(h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
            120 + 80 * np.cos(xx / 29.0) + 20 * np.sin(yy / 7.0),
            100 + 90 * np.sin((xx + yy) / 31.0),
        ],
        -1,
    )
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_fractal(h, w, seed=11):
    """1/f ("pink") random field per channel — the spectral shape of
    natural photographs."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    chans = []
    for c in range(3):
        spec = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) / rad
        f = np.real(np.fft.ifft2(spec))
        f = (f - f.min()) / (f.max() - f.min())
        chans.append(40 + 175 * f)
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def _img_edges(h, w, seed=13):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    g = np.where((xx // 37 + yy // 23) % 2 == 0, 205.0, 70.0)
    g += np.where((xx + 2 * yy) % 97 < 8, 40.0, 0.0)
    img = np.stack([g, 0.85 * g + 20, 255 - 0.7 * g], -1)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_oriented(h, w, seed=17):
    """Angled stripes with a slowly drifting orientation — the content
    class directional intra and rect partitions exist for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ang = 0.55 + 0.25 * np.sin(yy / 140.0)
    phase = xx * np.cos(ang) + yy * np.sin(ang)
    g = 128 + 62 * np.sin(phase / 4.3) + 18 * np.sin(phase / 23.0)
    img = np.stack([g, 0.88 * g + 14, 238 - 0.62 * g], -1)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_text(h, w, seed=19):
    """Text-like glyph strokes on a smooth gradient — screen content
    (the palette/IDTX class)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 60 + 140 * (xx + yy) / (h + w)  # diagonal gradient background
    glyph = np.zeros((h, w))
    for row in range(8, h - 16, 22):
        x = 10
        while x < w - 20:
            cw = int(rng.integers(4, 14))
            if rng.random() < 0.75:
                glyph[row : row + 12, x : x + 2] = 1  # vertical stroke
                if rng.random() < 0.5:
                    glyph[row : row + 2, x : x + cw] = 1  # top bar
                if rng.random() < 0.5:
                    glyph[row + 10 : row + 12, x : x + cw] = 1
            x += cw + 4
    g = np.where(glyph > 0, 16.0, g)
    img = np.stack([g, g * 0.96 + 4, g * 1.02], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _img_mixed(h, w, seed=23):
    """Mixed-scale structure: large smooth areas with embedded
    fine-detail patches — exercises partition adaptivity."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 110 + 70 * np.sin(xx / 190.0) * np.cos(yy / 160.0)
    for _ in range(10):
        py, px = rng.integers(0, h - 72), rng.integers(0, w - 72)
        ph, pw = rng.integers(28, 72), rng.integers(28, 72)
        fy, fx = rng.uniform(2.5, 6.0), rng.uniform(2.5, 6.0)
        sub = np.mgrid[0:ph, 0:pw]
        g[py : py + ph, px : px + pw] = 128 + 58 * np.sin(
            sub[1] / fx
        ) * np.cos(sub[0] / fy)
    img = np.stack([g, 0.9 * g + 12, 250 - 0.68 * g], -1)
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def corpus(size: int) -> dict:
    """The six seeded size x size RGB8 classes, by name."""
    return {
        "sinusoid": _img_sinusoid(size, size),
        "fractal": _img_fractal(size, size),
        "edges": _img_edges(size, size),
        "oriented": _img_oriented(size, size),
        "text": _img_text(size, size),
        "mixed": _img_mixed(size, size),
    }


def _make_ctx(img):
    from oavif_jax.backend import EncCtx
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions

    h, w = img.shape[:2]
    return EncCtx(
        o=EncOptions(speed=9),
        src=Image(width=w, height=h, channels=3, hbd=False, data=img),
        rgb=img,
        w=w,
        h=h,
    )


def _install_stage_timers():
    """Accumulating wall timers around the hot stages (VERDICT r2 #1:
    the headline must record where the time goes)."""
    import time as _t
    from collections import defaultdict

    acc = defaultdict(float)

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def timed(*a, **k):
            t0 = _t.perf_counter()
            out = fn(*a, **k)
            acc[label] += _t.perf_counter() - t0
            return out

        setattr(mod, name, timed)

    from oavif_jax.av1 import device_plan as _et
    from oavif_jax.av1.entropy import fast as _fast
    from oavif_jax.metric import native as _nat

    wrap(_fast, "tile_encode_native", "c_tile_encode")
    plan_fn = _et.FramePlanner.plan

    def timed_plan(self, *a, **k):
        t0 = _t.perf_counter()
        out = plan_fn(self, *a, **k)
        acc["device_plan"] += _t.perf_counter() - t0
        return out

    _et.FramePlanner.plan = timed_plan
    score_fn = _nat._RefCtx.score

    def timed_score(self, *a, **k):
        t0 = _t.perf_counter()
        out = score_fn(self, *a, **k)
        acc["metric"] += _t.perf_counter() - t0
        return out

    _nat._RefCtx.score = timed_score
    return acc


def main():
    from oavif_jax.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    import jax

    dev = require_gpu()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    size = int(os.environ.get("BENCH_SIZE", "512"))
    images = corpus(size)
    mp_total = sum(im.shape[0] * im.shape[1] / 1e6 for im in images.values())

    from oavif_jax.backend.oracle import OracleBackend
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.metric import compute_ssimulacra2
    from oavif_jax.tq import find_target_quality
    from oavif_jax.tq.driver import search_encode

    ours_backend = OavifBackend()
    oracle = OracleBackend()

    # compile the metric for the bench shape outside every timed region
    first = next(iter(images.values()))
    _ = compute_ssimulacra2(first, first)

    # ---- ours: full corpus wall (encode + metric + control), pipelined
    # across images (tq/pipeline.py): the device worker prefetches the
    # next image's plan (and, on fast links, scores probes) while the
    # host core encodes — the reference has no corpus-level overlap ----
    from oavif_jax.tq.pipeline import search_encode_corpus

    warm = _make_ctx(first)
    warm.o.max_pass = 1
    search_encode(warm, ours_backend)

    stage_acc = _install_stage_timers()
    ours = {}
    names = list(images.keys())

    def run_ours():
        ctxs = [_make_ctx(images[n]) for n in names]
        results = search_encode_corpus(ctxs, ours_backend)
        return (search_encode_corpus.last_wall, results,
                list(search_encode_corpus.last_host_s),
                search_encode_corpus.last_mode)

    def run_base():
        """One full baseline corpus pass: encode+decode timed, metric
        outside the timer (native in the reference). Returns
        (total_s, per-image rows)."""
        rows = {}
        total = 0.0
        for name, img in images.items():
            bctx = _make_ctx(img)
            codec_s = [0.0]

            def probe_base(q):
                bctx.q = q
                t0 = time.time()
                data = oracle.encode(bctx)
                dec = oracle.decode_to_rgb8(data)
                codec_s[0] += time.time() - t0
                return compute_ssimulacra2(img, dec)  # untimed

            bctx.num_pass = 0
            res_b = find_target_quality(probe_base, 80.0, 2.0, 6)
            rows[name] = {
                "s": round(codec_s[0], 3),
                "passes": res_b.num_pass,
                "q": res_b.q,
                "score": round(res_b.score, 2),
            }
            total += codec_s[0]
        return total, rows

    # best-of-3 each, INTERLEAVED so both sides sample the same box-load
    # window (single-core host timing drifts; measuring the two phases
    # back-to-back biased the ratio by whatever the load did in between)
    best_run = None
    best_base = None
    for _ in range(3):
        r = run_ours()
        if best_run is None or r[0] < best_run[0]:
            best_run = r
        b = run_base()
        if best_base is None or b[0] < best_base[0]:
            best_base = b

    ours_total_s, results, host_s, pipe_mode = best_run
    for name, (res, data), hs in zip(names, results, host_s):
        ours[name] = {
            "host_s": round(hs, 3),
            "passes": res.num_pass,
            "q": res.q,
            "score": round(res.score, 2),
            "bytes": len(data),
        }
    ours_mps = mp_total / ours_total_s
    base_total_s, base = best_base
    base_mps = mp_total / base_total_s

    print(
        json.dumps(
            {
                "metric": "MP/s at SSIMULACRA2 tgt 80 (tol 2), 6-image corpus",
                "value": round(ours_mps, 4),
                "unit": "MP/s",
                "vs_baseline": round(ours_mps / base_mps, 3) if base_mps else None,
                "detail": {
                    "device": device,
                    "ours_total_s": round(ours_total_s, 3),
                    "ours_stage_split_s": {
                        k: round(v, 3) for k, v in sorted(stage_acc.items())
                    },
                    "ours_stage_split_note": (
                        "accumulated over ALL runs incl. the discarded "
                        "best-of-N halves; remainder = search control, "
                        "loop filter/CDEF, conversions, mux"
                    ),
                    "ours_wall_includes_metric": True,
                    "ours_pipeline_scorer": pipe_mode,
                    "ours_wall_note": (
                        "ours_total_s is the single pipelined corpus "
                        "wall (tq/pipeline.py); per-image host_s is that "
                        "image's own host encode"
                        + (" + inline metric" if pipe_mode == "c" else
                           " (scoring overlapped on device)")
                        + "; the baseline runs strictly sequentially per "
                        "the reference's loop"
                    ),
                    "baseline_total_s": round(base_total_s, 3),
                    "baseline_timer_covers": "encode+decode only (metric untimed)",
                    "timing_protocol": (
                        "both sides: best single full-corpus pass of 3, "
                        "INTERLEAVED ours/baseline so they sample the "
                        "same box-load window (symmetric min-of-sums; "
                        "the old sum-of-per-image-mins favored whichever "
                        "side ran in the quieter phase)"
                    ),
                    "per_image_ours": ours,
                    "per_image_baseline": base,
                    "image": f"6x {size}x{size}",
                },
            }
        )
    )


if __name__ == "__main__":
    main()

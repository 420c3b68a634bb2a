"""Calibrate the content-adaptive TQ seed (round-3).

Generates a diverse synthetic 512x512 corpus, finds each image's exact
q*(tgt) by a fine-tolerance search, and fits q* against cheap content
features (luma high-frequency energy). Run with OAVIF_DEVICE_PLANNER=0 for
speed; the plan's effect on q* is < 1 quality step.

    OAVIF_DEVICE_PLANNER=0 python tools/calibrate_seed.py [tgt]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gen_corpus(size=512):
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    imgs = {}

    def sinus(noise, seed):
        r = np.random.default_rng(seed)
        img = np.stack(
            [
                128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
                120 + 80 * np.cos(xx / 29.0) + 20 * np.sin(yy / 7.0),
                100 + 90 * np.sin((xx + yy) / 31.0),
            ],
            -1,
        )
        img += r.normal(0, noise, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)

    for n in (0, 3, 6, 12):
        imgs[f"sinus_n{n}"] = sinus(n, 7 + n)

    def fractal(expo, seed, contrast=175):
        r = np.random.default_rng(seed)
        fy = np.fft.fftfreq(size)[:, None]
        fx = np.fft.fftfreq(size)[None, :]
        rad = np.sqrt(fy * fy + fx * fx)
        rad[0, 0] = 1.0
        chans = []
        for c in range(3):
            spec = (r.normal(size=(size, size)) + 1j * r.normal(size=(size, size))) / rad ** expo
            f = np.real(np.fft.ifft2(spec))
            f = (f - f.min()) / (f.max() - f.min())
            chans.append(40 + contrast * f)
        return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)

    imgs["fractal_1"] = fractal(1.0, 11)
    imgs["fractal_07"] = fractal(0.7, 12)  # more HF -> noisier
    imgs["fractal_15"] = fractal(1.5, 13)  # smoother

    def edges(noise, seed):
        r = np.random.default_rng(seed)
        g = np.where((xx // 37 + yy // 23) % 2 == 0, 205.0, 70.0)
        g += np.where((xx + 2 * yy) % 97 < 8, 40.0, 0.0)
        img = np.stack([g, 0.85 * g + 20, 255 - 0.7 * g], -1)
        img += r.normal(0, noise, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)

    imgs["edges_n3"] = edges(3, 13)
    imgs["edges_n8"] = edges(8, 14)

    g = 30 + 200 * (xx + yy) / (2 * size)
    imgs["gradient"] = np.clip(
        np.stack([g, 0.9 * g + 10, 255 - 0.6 * g], -1)
        + rng.normal(0, 1.5, (size, size, 3)),
        0,
        255,
    ).astype(np.uint8)

    # blurred noise (low-pass heavy)
    n = rng.normal(128, 60, (size, size, 3))
    from scipy import ndimage  # available? fall back to repeated box

    try:
        bl = ndimage.gaussian_filter(n, (6, 6, 0))
    except Exception:
        bl = n
    imgs["blurred_noise"] = np.clip(
        (bl - bl.mean()) * 3 + 128, 0, 255
    ).astype(np.uint8)

    # pure white noise (worst case)
    imgs["white_noise_lo"] = np.clip(
        rng.normal(128, 18, (size, size, 3)), 0, 255
    ).astype(np.uint8)
    return imgs


def luma_hf_energy(rgb):
    """Cheap HF feature: mean squared deviation of luma from its 3x3 box
    mean (computed on a 2x2-subsampled grid; ~1 ms at 512^2)."""
    y = (
        0.2126 * rgb[..., 0].astype(np.float32)
        + 0.7152 * rgb[..., 1]
        + 0.0722 * rgb[..., 2]
    )
    y = y[::2, ::2]
    box = (
        y[:-2, :-2] + y[:-2, 1:-1] + y[:-2, 2:]
        + y[1:-1, :-2] + y[1:-1, 1:-1] + y[1:-1, 2:]
        + y[2:, :-2] + y[2:, 1:-1] + y[2:, 2:]
    ) / 9.0
    d = y[1:-1, 1:-1] - box
    return float(np.mean(d * d))


def main():
    tgt = float(sys.argv[1]) if len(sys.argv) > 1 else 80.0
    import bench  # noqa: F401  (path setup)
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.metric.native import compute_ssimulacra2_native
    from oavif_jax.tq.driver import make_probe
    from oavif_jax.tq.search import find_target_quality

    imgs = gen_corpus()
    enc = OavifBackend()
    rows = []
    for name, img in imgs.items():
        ctx = bench._make_ctx(img)
        ctx.o.max_pass = 10
        p = make_probe(ctx, enc, lambda r, d: compute_ssimulacra2_native(r, d))
        res = find_target_quality(p, tgt, 0.75, 10)
        feat = luma_hf_energy(img)
        rows.append((name, feat, res.q, round(res.score, 2), ctx.num_pass))
        print(f"{name:16s} hf={feat:8.1f} q*={res.q} score={res.score:.2f} "
              f"passes={ctx.num_pass}")
    print("\nstatic seed would be:", round(0.72 * tgt + 26.5))
    feats = np.array([r[1] for r in rows])
    qs = np.array([r[2] for r in rows])
    lf = np.log2(feats + 1.0)
    A = np.stack([lf, np.ones_like(lf)], -1)
    coef, *_ = np.linalg.lstsq(A, qs, rcond=None)
    pred = A @ coef
    print(f"fit: q* ~ {coef[0]:.3f}*log2(hf+1) + {coef[1]:.2f}")
    for (name, feat, q, s, np_), pr in zip(rows, pred):
        print(f"  {name:16s} q*={q} pred={pr:.1f} err={pr-q:+.1f}")


if __name__ == "__main__":
    main()

"""SSIMULACRA2 perceptual metric in pure JAX (runs on the device).

The reference scores every search pass with fssimu2's computeSsimu2
(/root/reference/src/tq.zig:37), a native port of SSIMULACRA 2.1
(Jon Sneyers, libjxl tools). This is a from-scratch JAX implementation of
the published SSIMULACRA 2.1 algorithm:

  1. sRGB(8-bit) → linear RGB. The multi-scale pyramid lives in LINEAR
     RGB: each scale ≥ 1 box-downsamples the previous linear image by 2×2
     with edge-replicated odd borders (scale s is computed whenever the
     scale s−1 image is ≥ 8 px on both sides, up to 6 scales).
  2. Per scale, the (downsampled) linear RGB is converted to XYB (JPEG XL
     opsin absorbance, cbrt response) and positive-shifted:
     X' = 14X + 0.42, Y' = Y + 0.01, B' = (B − Y) + 0.55.
  3. Per scale/channel: Gaussian (σ=1.5) local statistics → a modified SSIM
     map (1 - (μ1-μ2)²)·(2cov + C2)/(var1 + var2 + C2) clamped error map,
     plus a ratio-of-local-edge-energy map split into "artifact" (edge
     appeared) and "detail lost" (edge vanished) halves.
  4. 1-norm and 4-norm of each of the three maps → 6 values per
     scale/channel → 108 features, dotted with the fitted weight vector;
     the dot d is mapped through the published nonlinearity
       d ← 0.9562382616834844·d
       d ← 2.326765642916932·d − 0.020884521182843837·d² + 6.248496625763138e−5·d³
       score = 100 − 10·d^0.6276336467831387   (100 if d ≤ 0).

Everything is static-shaped, fused elementwise + small separable
convolutions — XLA compiles it into device kernels with no host
round-trips. The distorted-image path is vmappable over a batch of
candidate quantizers while the reference-side statistics are computed once
(`ssimulacra2_precompute_ref`), which is what makes the TQ search's batched
speculative probing (BASELINE.json config 2) cheap.

NOTE ON CONSTANTS: the 108-entry weight vector and the final-nonlinearity
coefficients are reconstructions of the published SSIMULACRA 2.1 fit
(libjxl tools/ssimulacra2.cc; the same constants are replicated in the
public Rust/Zig ports, including the fssimu2 port the reference links).
The X and Y channel blocks (indices 0–71) were recovered twice
independently with identical values (high confidence); the B channel block
(72–107) and the cubic nonlinearity were recovered once (medium-high
confidence). No SSIMULACRA2 implementation exists on this host to diff
against (verified by scanning every binary for the distinctive
0.6276336467831387 pow constant), so tests/test_metric.py pins this
implementation's absolute scores on synthetic fixtures as self-goldens and
PARITY.md documents the expected deviation sources (FIR vs the upstream
recursive-IIR Gaussian; any residual weight-recall error).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NUM_SCALES = 6
_C2 = 0.0009
_SIGMA = 1.5
_KERNEL_RADIUS = 8  # exp(-r²/2σ²) < 3e-7 beyond r=8 at σ=1.5

# SSIMULACRA 2.1 fitted weights. Layout: channel-major (X, Y, B), then
# scale 0..5, then [ssim_1, artifact_1, detail_1, ssim_4, artifact_4,
# detail_4] per (channel, scale) — matching the published Score() loop
# order: for c, for scale, for n in (0,1): w·ssim[c*2+n], w·edge[c*4+n],
# w·edge[c*4+n+2].
WEIGHTS = np.array(
    [
        # --- X channel, scales 0..5 (6 weights each) ---
        0.0,
        0.0007376606707406586,
        0.0,
        0.0,
        0.0007793481682867309,
        0.0,
        0.0,
        0.0004371155730107379,
        0.0,
        1.1041726426657346,
        0.00066284834129271,
        0.00015231632783718752,
        0.0,
        0.0016406437456599754,
        0.0,
        1.8422455520539298,
        11.441172603757666,
        0.0,
        0.0007989109436015163,
        0.000176816438078653,
        0.0,
        1.8787594979546387,
        10.94906990605142,
        0.0,
        0.0007289346991508072,
        0.9677937080626833,
        0.0,
        0.00014003424285435884,
        0.9981766977854967,
        0.00031949755934435053,
        0.0004550992113792063,
        0.0,
        0.0,
        0.0013648766163243398,
        0.0,
        0.0,
        # --- Y channel, scales 0..5 ---
        7.466890328078848,
        0.0,
        17.445833984131262,
        0.0006235601634041466,
        0.0,
        0.0,
        6.683678146179332,
        0.00037724407979611296,
        1.027889937768264,
        225.20515300849274,
        0.0,
        0.0,
        19.213238186143016,
        0.0011401524586618361,
        0.001237755635509985,
        176.39317598450694,
        0.0,
        0.0,
        24.43300999870476,
        0.28520802612117757,
        0.0004485436923833408,
        0.0,
        0.0,
        0.0,
        34.77906344483772,
        44.835625328877896,
        0.0,
        0.0008680556573291698,
        0.0005313191874358747,
        0.0,
        0.00016533814161379112,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0005895391724029294,
        # --- B channel, scales 0..5 ---
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0,
        0.0004179171803251336,
        0.0017290828234722833,
        0.0,
        0.0020827005846636437,
        0.0,
        0.0,
        8.826982764996862,
        23.19243343998926,
        0.0,
        95.1080498811086,
        0.9863978034400682,
        0.9834382792465353,
        0.0012286405048278493,
        171.2667255897307,
        0.9807858872435379,
        0.0,
        0.0,
        0.0,
        0.0005130064588990679,
        0.0,
        0.00010854057858411537,
        0.0,
        0.0,
        0.0,
    ],
    dtype=np.float64,
)
assert WEIGHTS.shape == (108,)

_FINAL_POW = 0.6276336467831387
_FINAL_SCALE = 0.9562382616834844
_CUBIC = (2.326765642916932, -0.020884521182843837, 6.248496625763138e-05)


def _finalize_score(dot: jnp.ndarray) -> jnp.ndarray:
    """Published v2.1 Score() tail: scale, cubic, then 100 − 10·d^p."""
    d = dot * _FINAL_SCALE
    d = _CUBIC[0] * d + _CUBIC[1] * d * d + _CUBIC[2] * d * d * d
    return jnp.where(
        d > 0.0, 100.0 - 10.0 * jnp.power(jnp.maximum(d, 0.0), _FINAL_POW), 100.0
    )


# ---------------------------------------------------------------------------
# Color transforms
# ---------------------------------------------------------------------------


def srgb_to_linear(x: jnp.ndarray) -> jnp.ndarray:
    """sRGB EOTF on [0,1]."""
    return jnp.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


_OPSIN_BIAS = 0.0037930732552754493
_CBRT_OPSIN_BIAS = _OPSIN_BIAS ** (1.0 / 3.0)
# JPEG XL opsin absorbance matrix (rows: L, M, S mix of linear RGB).
_OPSIN_M = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=np.float32,
)


def linear_rgb_to_xyb_positive(rgb: jnp.ndarray) -> jnp.ndarray:
    """Planar linear RGB (3, H, W) → positive-shifted XYB (3, H, W)."""
    mixed = jnp.einsum(
        "chw,mc->mhw", rgb, jnp.asarray(_OPSIN_M), precision=jax.lax.Precision.HIGHEST
    )
    gam = jnp.cbrt(jnp.maximum(mixed + _OPSIN_BIAS, 0.0)) - _CBRT_OPSIN_BIAS
    l, m, s = gam[0], gam[1], gam[2]
    x = (l - m) * 0.5
    y = (l + m) * 0.5
    b = s
    # MakePositiveXYB (ssimulacra2.cc): B-Y+0.55 uses the unshifted Y.
    return jnp.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55])


def rgb8_to_linear(rgb8: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W, 3) sRGB → planar linear RGB (3, H, W) float32.

    The multi-scale pyramid is built in THIS space (the upstream tool
    downsamples linear RGB and converts each scale to XYB afterwards —
    the opsin cbrt is nonlinear, so the order matters)."""
    x = rgb8.astype(jnp.float32) * (1.0 / 255.0)
    return jnp.transpose(srgb_to_linear(x), (2, 0, 1))


# ---------------------------------------------------------------------------
# Blur and downsample
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gauss_kernel(radius: int = _KERNEL_RADIUS) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / _SIGMA) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def kernel_l1_error(radius: int) -> float:
    """L1 distance between the radius-`radius` normalized kernel and the
    (effectively exact) radius-8 one — the knob behind the blur
    sensitivity bound in tests/test_metric.py / PARITY.md."""
    full = _gauss_kernel(_KERNEL_RADIUS).astype(np.float64)
    trunc = _gauss_kernel(radius).astype(np.float64)
    pad = np.zeros_like(full)
    off = _KERNEL_RADIUS - radius
    pad[off : off + len(trunc)] = trunc
    return float(np.abs(full - pad).sum())


@functools.lru_cache(maxsize=None)
def _yvv_coeffs():
    """Young–van Vliet 3rd-order recursive Gaussian coefficients, σ=1.5
    (the classic q-polynomial fit; the upstream tool uses a recursive-IIR
    Gaussian of this family). Returns (B, b1/b0, b2/b0, b3/b0)."""
    sigma = _SIGMA
    q = 3.97156 - 4.14554 * np.sqrt(1.0 - 0.26891 * sigma)
    b0 = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q ** 3
    b1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q ** 3
    b2 = -(1.4281 * q * q + 1.26661 * q ** 3)
    b3 = 0.422205 * q ** 3
    B = 1.0 - (b1 + b2 + b3) / b0
    return (np.float32(B), np.float32(b1 / b0), np.float32(b2 / b0),
            np.float32(b3 / b0))


def _iir_pass_1d(x: jnp.ndarray) -> jnp.ndarray:
    """Forward+backward YvV recursion along the LAST axis, zero initial
    state (matching the FIR path's zero padding)."""
    B, a1, a2, a3 = _yvv_coeffs()

    def fwd(carry, xt):
        w1, w2, w3 = carry
        w = B * xt + a1 * w1 + a2 * w2 + a3 * w3
        return (w, w1, w2), w

    def bwd(carry, wt):
        y1, y2, y3 = carry
        y = B * wt + a1 * y1 + a2 * y2 + a3 * y3
        return (y, y1, y2), y

    xt = jnp.moveaxis(x, -1, 0)
    z = jnp.zeros_like(xt[0])
    _, w = jax.lax.scan(fwd, (z, z, z), xt)
    _, y = jax.lax.scan(bwd, (z, z, z), w[::-1])
    return jnp.moveaxis(y[::-1], 0, -1)


def blur_iir(img: jnp.ndarray) -> jnp.ndarray:
    """Recursive-IIR Gaussian σ=1.5 over (C, H, W) — the upstream blur
    family. Used to BOUND the FIR-vs-IIR deviation empirically
    (tests/test_metric.py pins the measured delta); select with
    OAVIF_METRIC_BLUR=iir."""
    x = _iir_pass_1d(img)  # rows
    x = jnp.swapaxes(_iir_pass_1d(jnp.swapaxes(x, -1, -2)), -1, -2)
    return x


def blur(img: jnp.ndarray) -> jnp.ndarray:
    """Separable Gaussian σ=1.5 over (C, H, W), zero-padded borders
    (matches the recursive-Gaussian zero initial state used upstream)."""
    import os

    sel = os.environ.get("OAVIF_METRIC_BLUR", "")
    if sel == "iir":
        return blur_iir(img)
    if sel.startswith("fir_r"):  # truncated-kernel sensitivity probes
        return _blur_fir(img, int(sel[5:]))
    return _blur_fir(img, _KERNEL_RADIUS)


def _blur_fir(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    k = jnp.asarray(_gauss_kernel(radius))
    c, h, w = img.shape
    # Horizontal then vertical, as grouped 1D convolutions.
    x = img[:, None]  # (C, 1, H, W) — N=C, C=1
    kh = k.reshape(1, 1, 1, -1)
    # precision=HIGHEST keeps the convs in full f32: the GPU default runs
    # float32 convs in TF32, whose ~3 digits break the identical-image ==
    # 100.0 invariant and the 0.05 agreement with the C scorer.
    x = jax.lax.conv_general_dilated(
        x,
        kh,
        window_strides=(1, 1),
        padding=((0, 0), (radius,) * 2),
        precision=jax.lax.Precision.HIGHEST,
    )
    kv = k.reshape(1, 1, -1, 1)
    x = jax.lax.conv_general_dilated(
        x,
        kv,
        window_strides=(1, 1),
        padding=((radius,) * 2, (0, 0)),
        precision=jax.lax.Precision.HIGHEST,
    )
    return x[:, 0]


def downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2×2 box downsample of (C, H, W) with edge replication on odd sizes
    (ssimulacra2.cc Downsample)."""
    c, h, w = img.shape
    ph, pw = (-h) % 2, (-w) % 2
    x = jnp.pad(img, ((0, 0), (0, ph), (0, pw)), mode="edge")
    x = x.reshape(c, (h + ph) // 2, 2, (w + pw) // 2, 2)
    return x.mean(axis=(2, 4))


# ---------------------------------------------------------------------------
# Per-scale statistics
# ---------------------------------------------------------------------------


def ssim_error_map(mu1, mu2, s11, s22, s12) -> jnp.ndarray:
    """Modified-SSIM error map max(1 - num_m * num_s / den_s, 0), written
    as (den_s - num_m * num_s) / den_s: for identical inputs num_m is 1
    and num_s equals den_s bit for bit, so the map is exactly 0 even
    where the division is not correctly rounded (the GPU's is not, and
    the score's 0.63 power turns a 1e-7 residue into 0.02 points)."""
    var1 = s11 - mu1 * mu1
    var2 = s22 - mu2 * mu2
    cov = s12 - mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * cov + _C2
    den_s = (var1 + var2) + _C2
    return jnp.maximum((den_s - num_m * num_s) / den_s, 0.0)


def edge_diff_maps(img1, mu1, img2, mu2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ratio-of-local-edge maps (artifact, detail lost). The ratio
    (1 + |img2 - mu2|) / (1 + |img1 - mu1|) - 1 is written as a
    difference over (1 + |img1 - mu1|), exactly 0 for identical inputs
    (see ssim_error_map)."""
    e1 = jnp.abs(img1 - mu1)
    d1 = (jnp.abs(img2 - mu2) - e1) / (1.0 + e1)
    return jnp.maximum(d1, 0.0), jnp.maximum(-d1, 0.0)


def _norms(m) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(1-norm, 4-norm) of a (3, H, W) map per channel."""
    return m.mean(axis=(1, 2)), jnp.sqrt(jnp.sqrt((m ** 4).mean(axis=(1, 2))))


def _num_scales(h: int, w: int) -> int:
    """Scales actually computed: the upstream loop checks the PRE-downsample
    size each iteration, so scale s (s ≥ 1) runs whenever the scale s−1
    image is ≥ 8 px on both sides (an 8×8 input gets 2 scales)."""
    n = 0
    for s in range(NUM_SCALES):
        if h < 8 or w < 8:
            break
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        n += 1
    return n


def ssimulacra2_precompute_ref(ref_rgb8: jnp.ndarray):
    """Precompute the reference-side pyramid: per scale (img1, mu1, s11).

    Returns a list of tuples usable by :func:`ssimulacra2_from_precomputed`
    so batched candidate scoring never recomputes reference statistics.
    """
    h, w = ref_rgb8.shape[:2]
    lin1 = rgb8_to_linear(ref_rgb8)
    out = []
    for s in range(_num_scales(h, w)):
        if s:
            lin1 = downsample2(lin1)
        img1 = linear_rgb_to_xyb_positive(lin1)
        mu1 = blur(img1)
        s11 = blur(img1 * img1)
        out.append((img1, mu1, s11))
    return out


def ssimulacra2_from_precomputed(ref_pyr, dist_rgb8: jnp.ndarray) -> jnp.ndarray:
    """Score a distorted image against a precomputed reference pyramid."""
    lin2 = rgb8_to_linear(dist_rgb8)
    feats: List[jnp.ndarray] = []  # per scale: (3, 6) channel-major features
    for s, (img1, mu1, s11) in enumerate(ref_pyr):
        if s:
            lin2 = downsample2(lin2)
        img2 = linear_rgb_to_xyb_positive(lin2)
        mu2 = blur(img2)
        s22 = blur(img2 * img2)
        s12 = blur(img1 * img2)
        ssim1, ssim4 = _norms(ssim_error_map(mu1, mu2, s11, s22, s12))
        artifact, detail = edge_diff_maps(img1, mu1, img2, mu2)
        a1, a4 = _norms(artifact)
        l1, l4 = _norms(detail)
        feats.append(jnp.stack([ssim1, a1, l1, ssim4, a4, l4], axis=-1))

    nsc = len(ref_pyr)
    # (scales, 3, 6) → channel-major (3, scales, 6) → flat
    f = jnp.abs(jnp.stack(feats).transpose(1, 0, 2).reshape(-1))
    wmat = jnp.asarray(
        WEIGHTS.reshape(3, NUM_SCALES, 6)[:, :nsc, :].reshape(-1), dtype=jnp.float32
    )
    dot = jnp.sum(f * wmat)
    return _finalize_score(dot)


@functools.partial(jax.jit, static_argnames=())
def _score_pair(ref_rgb8: jnp.ndarray, dist_rgb8: jnp.ndarray) -> jnp.ndarray:
    pyr = ssimulacra2_precompute_ref(ref_rgb8)
    return ssimulacra2_from_precomputed(pyr, dist_rgb8)


def compute_ssimulacra2(ref_rgb8, dist_rgb8) -> float:
    """Score two (H, W, 3) uint8 RGB images. Drop-in for the reference's
    fssimu2.computeSsimu2 call (tq.zig:37)."""
    ref = jnp.asarray(np.ascontiguousarray(ref_rgb8), dtype=jnp.uint8)
    dist = jnp.asarray(np.ascontiguousarray(dist_rgb8), dtype=jnp.uint8)
    if ref.shape != dist.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {dist.shape}")
    if ref.shape[0] < 8 or ref.shape[1] < 8:
        raise ValueError("SSIMULACRA2 requires images at least 8x8")
    return float(_score_pair(ref, dist))


_score_with_pyr = jax.jit(ssimulacra2_from_precomputed)
_precompute_jit = jax.jit(ssimulacra2_precompute_ref)


def make_ref_scorer(ref_rgb8):
    """Return a scorer closure with the reference pyramid resident on the
    device: per-probe cost drops to the distorted-side statistics only
    (the TQ loop scores many candidates against one reference)."""
    ref = jnp.asarray(np.ascontiguousarray(ref_rgb8), dtype=jnp.uint8)
    if ref.shape[0] < 8 or ref.shape[1] < 8:
        raise ValueError("SSIMULACRA2 requires images at least 8x8")
    pyr = _precompute_jit(ref)

    def score(_ref_ignored, dist_rgb8) -> float:
        d = jnp.asarray(np.ascontiguousarray(dist_rgb8), dtype=jnp.uint8)
        return float(_score_with_pyr(pyr, d))

    return score


@functools.partial(jax.jit, static_argnames=())
def _score_batch(ref_rgb8: jnp.ndarray, dist_batch: jnp.ndarray) -> jnp.ndarray:
    pyr = ssimulacra2_precompute_ref(ref_rgb8)
    return jax.vmap(lambda d: ssimulacra2_from_precomputed(pyr, d))(dist_batch)


def compute_ssimulacra2_batch(ref_rgb8, dist_batch) -> np.ndarray:
    """Score a (N, H, W, 3) batch of candidates against one reference in a
    single device step (the TQ loop's batched speculative probing)."""
    ref = jnp.asarray(np.ascontiguousarray(ref_rgb8), dtype=jnp.uint8)
    dist = jnp.asarray(np.ascontiguousarray(dist_batch), dtype=jnp.uint8)
    return np.asarray(_score_batch(ref, dist))

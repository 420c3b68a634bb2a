"""Empirical probe of the decoder's exact rect (32x16) inverse-transform
rounding sequence.

Crafts bitstreams whose first 32x16 block carries handpicked coefficient
LEVELS over a flat-128 DC prediction (frame corner: no neighbors), decodes
with the dav1d oracle, and compares the extracted exact residual against a
family of candidate inverse implementations built from the proven-exact 1D
idct stages (transform.py idct_1d, bit-exact vs dav1d on squares).

Run: python tools/probe_rect_inverse.py
"""
import sys

import numpy as np

sys.path.insert(0, ".")

from oavif_jax.av1.frame import TileEncoder
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream
from oavif_jax.av1.transform import idct_1d, _round2
from oavif_jax.io.avif_ctypes import decode_to_yuv

H, W = 32, 64
TH, TW = 16, 32  # the 32x16 block (w=32, h=16)
QINDEX = 40


def dav1d_residual(levels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode a stream whose first 32x16 y-txb has exactly `levels`,
    decode with dav1d, return (dav1d residual, our dq coeff array)."""
    planes = [np.full((H, W), 128, np.int32) for _ in range(3)]
    te = TileEncoder([p.copy() for p in planes], QINDEX, 8, 9)
    te._force_rect_test = True
    calls = {"n": 0}
    orig = te._quantize_rect

    def patched(resid, th, tw, ptype):
        calls["n"] += 1
        if calls["n"] == 1:
            assert (th, tw) == (TH, TW), (th, tw)
            return levels.astype(np.int64)
        return np.zeros((th, tw), np.int64)

    te._quantize_rect = patched
    payload = te.encode()
    seq = SequenceConfig(width=W, height=H, bit_depth=8)
    frame = FrameConfig(width=W, height=H, base_q_idx=QINDEX)
    avif = mux_avif(
        assemble_av1_stream(seq, frame, [payload]), W, H,
        bit_depth=8, high_bitdepth=False, cicp=(2, 2, 2),
    )
    yuv, _, _ = decode_to_yuv(avif)
    dec = yuv[0][:TH, :TW].astype(np.int64)
    resid = dec - 128
    if (dec == 0).any() or (dec == 255).any():
        raise RuntimeError("clipped: choose smaller levels")
    # our dq coeffs (mirror _dequant_inv_rect's dequant)
    q = np.full_like(levels, te.dq_ac)
    q[0, 0] = te.dq_dc
    mag = (np.abs(levels) * q) & 0xFFFFFF
    dq = np.sign(levels) * mag
    return resid, dq


def rows_cols(t, w, h, row_shift, pre=None, mid=None, clamp_bits=15,
              col_first=False, final_shift=4):
    """Parametrized 2D inverse from the proven 1D stages."""
    t = t.astype(np.int64)
    if pre is not None:
        t = pre(t)
    if not col_first:
        # rows: w-point over each row
        cols_in = [t[:, i] for i in range(w)]
        out = idct_1d(cols_in, w)
        t = np.stack(out, axis=1)
        if mid is not None:
            t = mid(t)
        t = _round2(t, row_shift) if row_shift else t
        cl = (1 << clamp_bits) - 1
        t = np.clip(t, -cl - 1, cl)
        rows_in = [t[i, :] for i in range(h)]
        out = idct_1d(rows_in, h)
        t = np.stack(out, axis=0)
    else:
        rows_in = [t[i, :] for i in range(h)]
        out = idct_1d(rows_in, h)
        t = np.stack(out, axis=0)
        if mid is not None:
            t = mid(t)
        t = _round2(t, row_shift) if row_shift else t
        cl = (1 << clamp_bits) - 1
        t = np.clip(t, -cl - 1, cl)
        cols_in = [t[:, i] for i in range(w)]
        out = idct_1d(cols_in, w)
        t = np.stack(out, axis=1)
    return _round2(t, final_shift)


def sc2896(x):
    return _round2(x * 2896, 12)


def sc181(x):  # identical to sc2896; kept to guard the equivalence
    return (x * 181 + 128) >> 8


def sc181_away(x):  # round half away from zero
    s = np.sign(x)
    return s * ((np.abs(x) * 181 + 128) >> 8)


def sc5793(x):
    return _round2(x * 5793, 12)


CANDIDATES = {
    "A_current(pre2896,rs2)": lambda t: rows_cols(t, TW, TH, 2, pre=sc2896),
    "B_pre181,rs1": lambda t: rows_cols(t, TW, TH, 1, pre=sc181),
    "C_pre181away,rs2": lambda t: rows_cols(t, TW, TH, 2, pre=sc181_away),
    "D_mid2896,rs2": lambda t: rows_cols(t, TW, TH, 2, mid=sc2896),
    "E_pre2896,rs2,colfirst": lambda t: rows_cols(
        t, TW, TH, 2, pre=sc2896, col_first=True),
    "F_pre2896,rs1": lambda t: rows_cols(t, TW, TH, 1, pre=sc2896),
    "G_pre5793,rs3": lambda t: rows_cols(t, TW, TH, 3, pre=sc5793),
    "H_nopre,rs2,final5_2896mid": lambda t: rows_cols(
        t, TW, TH, 2, mid=None, pre=None, final_shift=4),
    "I_pre2896,rs2,clamp13": lambda t: rows_cols(
        t, TW, TH, 2, pre=sc2896, clamp_bits=13),
    "J_fused_rs2_2896": lambda t: rows_cols(
        t, TW, TH, 0, pre=sc2896,
        mid=lambda x: _round2(x, 2)),
}


def main():
    rng = np.random.default_rng(7)
    cases = []
    # single-coefficient sweeps
    for (r, c) in [(0, 0), (0, 1), (1, 0), (1, 1), (2, 3), (5, 2), (0, 7),
                   (7, 0), (3, 11)]:
        for v in (1, -1, 2, 3, -3):
            lv = np.zeros((TH, TW), np.int64)
            lv[r, c] = v
            cases.append((f"single({r},{c})={v}", lv))
    # small dense patterns
    for i in range(3):
        lv = rng.integers(-2, 3, (TH, TW)).astype(np.int64)
        lv[4:, :] = 0
        lv[:, 8:] = 0
        cases.append((f"dense{i}", lv))

    stats = {k: [0, 0, 0] for k in CANDIDATES}  # exact, maxdiff, cases
    first_fail = {k: None for k in CANDIDATES}
    for name, lv in cases:
        try:
            resid, dq = dav1d_residual(lv)
        except RuntimeError as e:
            print(f"{name}: {e}")
            continue
        for k, fn in CANDIDATES.items():
            ours = fn(dq)
            d = np.abs(ours - resid)
            stats[k][2] += 1
            if d.max() == 0:
                stats[k][0] += 1
            else:
                stats[k][1] = max(stats[k][1], int(d.max()))
                if first_fail[k] is None:
                    first_fail[k] = (name, int(d.max()), int(d.sum()))
    print(f"\n=== results over {stats[next(iter(stats))][2]} cases ===")
    for k, (ex, md, n) in stats.items():
        ff = first_fail[k]
        print(f"{k:34s} exact {ex}/{n}  maxdiff {md}  first-fail {ff}")


if __name__ == "__main__":
    main()

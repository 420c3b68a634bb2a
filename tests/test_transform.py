"""Transform correctness: structure vs float DCT-III, native vs Python
bit-identity, forward/inverse round trip."""

import numpy as np
import pytest

from oavif_jax.av1 import transform as T


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_idct_structure_matches_float_dct3(n):
    M = T._inv_matrix_1d(n)
    nn = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    C = np.cos(np.pi * k * (2 * nn + 1) / (2 * n))
    C[:, 0] *= 1 / np.sqrt(2)
    s = (M * C).sum() / (C * C).sum()
    assert np.abs(M - s * C).max() / abs(s) < 0.005


@pytest.mark.parametrize("size", [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64)])
def test_native_matches_python_inverse(size, rng):
    from oavif_jax.av1.entropy.fast import inv_txfm2d_native, get_lib

    if get_lib() is None:
        pytest.skip("native lib unavailable")
    h, w = size
    coeffs = rng.integers(-2000, 2000, (h, w)).astype(np.int64)
    if w == 64:
        coeffs[:, 32:] = 0
    if h == 64:
        coeffs[32:, :] = 0
    # Python path (force by calling internals)
    t = coeffs.astype(np.int64)
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    tt = t.copy()
    cols_in = [tt[:, i] for i in range(w)]
    rows_out = T.idct_1d(cols_in, w)
    tt = np.stack(rows_out, axis=1)
    rs = T.INV_ROW_SHIFT[max(w, h)]
    if rs:
        tt = T._round2(tt, rs)
    clamp = (1 << (8 + 8 - 1)) - 1
    tt = np.clip(tt, -clamp - 1, clamp)
    rows_in = [tt[i, :] for i in range(h)]
    cols_out = T.idct_1d(rows_in, h)
    tt = T._round2(np.stack(cols_out, axis=0), 4)

    native = inv_txfm2d_native(coeffs)
    np.testing.assert_array_equal(native, tt)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_forward_inverse_roundtrip(n, rng):
    resid = rng.integers(-200, 200, (n, n)).astype(np.int64)
    coeffs = np.round(T.fwd_txfm2d(resid)).astype(np.int64)
    back = T.inv_txfm2d(coeffs)
    err = np.abs(back - resid).max()
    assert err <= 2, err


def test_adst_roundtrip_all_sizes(rng):
    from oavif_jax.av1.transform import fwd_txfm2d, inv_txfm2d
    import numpy as np

    for n in (4, 8, 16):
        for tt in ("adst_adst", "adst_dct", "dct_adst"):
            x = rng.integers(-255, 256, (n, n))
            c = np.round(fwd_txfm2d(x, tt)).astype(np.int64)
            y = inv_txfm2d(c, 8, tt)
            assert np.abs(y - x).max() <= 1, (n, tt)


# ---------------------------------------------------------------------------
# Rectangular-transform groundwork (round-4 rect partitions)
# ---------------------------------------------------------------------------


def test_rect_scans_are_transposed_pairs():
    """The extracted rect scan tables: valid anti-diagonal permutations,
    DC first, and each wide/tall pair is an exact transpose of the other
    (the AV1 structural relation — strong evidence the right rodata
    tables were found)."""
    from oavif_jax.av1.tables import TABLES

    for name, n, w in [("scan_4x8", 32, 4), ("scan_8x4", 32, 8),
                       ("scan_8x16", 128, 8), ("scan_16x8", 128, 16),
                       ("scan_16x32", 512, 16), ("scan_32x16", 512, 32)]:
        s = np.asarray(TABLES[name])
        assert s[0] == 0 and s[-1] == n - 1
        assert np.array_equal(np.sort(s), np.arange(n)), name
        r, c = s // w, s % w
        assert np.all(np.diff((r + c).astype(np.int64)) >= 0), name
    for wide, tall, ww, wt in [("scan_8x4", "scan_4x8", 8, 4),
                               ("scan_16x8", "scan_8x16", 16, 8),
                               ("scan_32x16", "scan_16x32", 32, 16)]:
        t = np.asarray(TABLES[tall])
        tp = (t % wt) * ww + (t // wt)
        assert np.array_equal(tp, np.asarray(TABLES[wide])), (wide, tall)


@pytest.mark.parametrize("h,w", [(4, 8), (8, 4), (8, 16), (16, 8),
                                 (16, 32), (32, 16)])
def test_rect_forward_inverse_roundtrip(h, w, rng):
    """fwd_matrices/inv_txfm2d already handle rect shapes (the sqrt2
    stage scale included): an exact forward of a residual must come back
    through the normative integer inverse within rounding distance."""
    from oavif_jax.av1.transform import fwd_matrices, inv_txfm2d

    resid = rng.integers(-255, 256, (h, w)).astype(np.int64)
    fh, fw = fwd_matrices(w, h)
    coeffs = fh @ resid.astype(np.float64) @ fw.T
    back = inv_txfm2d(np.round(coeffs).astype(np.int64), bitdepth=8)
    err = np.abs(back - resid).max()
    assert err <= 2, (h, w, err)


@pytest.mark.parametrize("h,w", [(4, 8), (16, 8), (32, 16)])
def test_rect_int16_forward_roundtrip(h, w, rng):
    """The Q12 integer forward path (the production quantizer's front
    end) handles rect shapes: exact int pipeline, inverse within 1 LSB."""
    from oavif_jax.av1.transform import fwd_matrices_int16, inv_txfm2d

    fh16, fw16, sa = fwd_matrices_int16(w, h, "dct_dct", 8)
    resid = rng.integers(-255, 256, (h, w)).astype(np.int32)
    acc1 = fh16.astype(np.int32) @ resid
    tmp16 = (acc1 + (1 << sa >> 1)) >> sa if sa else acc1
    out32 = tmp16.astype(np.int32) @ fw16.astype(np.int32).T
    c = np.round(out32.astype(np.float64) / (1 << (24 - sa))).astype(np.int64)
    back = inv_txfm2d(c, bitdepth=8)
    assert np.abs(back - resid).max() <= 1, (h, w)

"""Extract AV1 specification constant tables from the system libaom binary.

The AV1 bitstream's default CDF initializations, quantizer lookup tables,
scan orders, and prediction weight tables are normative constants from the
AV1 specification. The environment has no machine-readable copy of the spec,
but the Debian libaom runtime (/usr/lib/x86_64-linux-gnu/libaom.so.3) embeds
them in .rodata. This tool locates each table by structural signature
(libaom stores CDFs as inverse-CDF Q15 arrays: strictly decreasing values
then a 0 terminator and a 0 adaptation counter) and verifies known anchor
values from the specification before emitting `oavif_jax/av1/av1_tables.npz`.

Every extracted table is independently validated end-to-end by the
conformance tests: bitstreams produced with these tables must decode
bit-exactly through libavif/dav1d (tests/test_conformance.py).

Usage: python tools/extract_av1_tables.py
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3.6.0"
OUT = Path(__file__).resolve().parent.parent / "oavif_jax" / "av1" / "av1_tables.npz"


def load_rodata() -> np.ndarray:
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        subprocess.run(
            ["objcopy", "-O", "binary", "--only-section=.rodata", LIBAOM, f.name],
            check=True,
        )
        return np.fromfile(f.name, dtype="<u2").copy()


def parse_cdf_units(d, start, max_units=10**9):
    """Parse consecutive CDF units at u16 offset `start`.

    Returns (list of (offset, nsym), end_offset). A unit for an N-symbol CDF
    is N-1 strictly-decreasing values in (0, 32768) followed by 0, 0.
    """
    units = []
    i = start
    n = len(d)
    while i < n and len(units) < max_units:
        j = i
        while j < n and 0 < d[j] < 32768 and (j == i or d[j] < d[j - 1]):
            j += 1
        k = j - i
        if k == 0 or j + 1 >= n or d[j] != 0 or d[j + 1] != 0:
            break
        units.append((i, k + 1))
        i = j + 2
    return units, i


def icdf_unit(d, off, nsym):
    """Return one CDF as nsym ICDF values (last is 0), dtype uint16."""
    out = np.zeros(nsym, dtype=np.uint16)
    out[: nsym - 1] = d[off : off + nsym - 1]
    return out


def take_table(d, start, shape, nsym, stride=None):
    """Read prod(shape) consecutive CDF units of nsym symbols each.

    ``stride`` (u16 per row) handles storage padded wider than
    CDF_SIZE(nsym) — e.g. the 13-symbol uv_mode CDFs stored in
    CDF_SIZE(14)=15-wide rows. Returns (array shaped shape + (nsym,),
    end offset).
    """
    count = int(np.prod(shape))
    if stride is None:
        units, end = parse_cdf_units(d, start, count)
        assert len(units) == count, (start, shape, nsym, len(units))
        assert all(u[1] == nsym for u in units), (start, shape, nsym)
        arr = np.stack([icdf_unit(d, off, nsym) for off, _ in units])
        return arr.reshape(tuple(shape) + (nsym,)), end
    rows = []
    for r in range(count):
        off = start + r * stride
        row = d[off : off + stride]
        vals = row[: nsym - 1].astype(np.int64)
        assert np.all(vals[:-1] > vals[1:]) and 0 < vals[0] < 32768, (start, r)
        assert np.all(row[nsym - 1 :] == 0), (start, r, row.tolist())
        rows.append(np.concatenate([row[: nsym - 1], [0]]).astype(np.uint16))
    arr = np.stack(rows)
    return arr.reshape(tuple(shape) + (nsym,)), start + count * stride


def load_rodata_bytes() -> np.ndarray:
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        subprocess.run(
            ["objcopy", "-O", "binary", "--only-section=.rodata", LIBAOM, f.name],
            check=True,
        )
        return np.fromfile(f.name, dtype=np.uint8).copy()


def find_filter_intra_taps(rod8: np.ndarray) -> np.ndarray:
    s = rod8.astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(s)])
    row16 = (cs[8:] - cs[:-8]) == 16
    for off in range(len(rod8) - 320):
        if not row16[off]:
            continue
        if rod8[off] != -6:  # anchor the canonical first row
            continue
        if all(row16[off + 8 * k] for k in range(40)):
            v = rod8[off : off + 320]
            if v.max() <= 20 and v.min() >= -20:
                return v.reshape(5, 8, 8).astype(np.int8)
    raise AssertionError("filter-intra taps not found")


def find_u16_seq(d, seq):
    seq = np.asarray(seq, dtype="<u2")
    # naive scan with early filter on first element
    idxs = np.nonzero(d[: len(d) - len(seq)] == seq[0])[0]
    for i in idxs:
        if np.array_equal(d[i : i + len(seq)], seq):
            return int(i)
    raise AssertionError(f"sequence not found: {seq[:8]}")


def icdf(probs):
    return [32768 - p for p in probs]


def main():
    d = load_rodata()
    out = {}

    # ---- quantizer lookup tables (spec: Dc_Qlookup / Ac_Qlookup) ----
    # libaom layout: ac12, ac10, ac8, dc12, dc10, dc8 contiguous.
    ac12_off = find_u16_seq(d, [4, 13, 19, 27, 35, 44])
    names = ["ac_q12", "ac_q10", "ac_q8", "dc_q12", "dc_q10", "dc_q8"]
    for k, name in enumerate(names):
        seg = d[ac12_off + 256 * k : ac12_off + 256 * (k + 1)].astype(np.int32)
        assert np.all(np.diff(seg) >= 0) and seg[0] == 4, name
        out[name] = seg
    # spec anchor endpoints
    assert out["ac_q8"][255] == 1828 and out["dc_q8"][255] == 1336
    assert out["ac_q10"][255] == 7312 and out["dc_q10"][255] == 5347
    assert out["ac_q12"][255] == 29247 and out["dc_q12"][255] == 21387

    # ---- coefficient CDFs (token_cdfs region) ----
    # Region order in .rodata: coeff_base_eob, coeff_base, coeff_br.
    cbe_off = find_u16_seq(d, icdf([17837, 29055]) + [0, 0])
    t, end = take_table(d, cbe_off, (4, 5, 2, 4), 3)
    out["coeff_base_eob"] = t  # [qctx][txsz][plane][ctx][3]
    t, end = take_table(d, end, (4, 5, 2, 42), 4)
    out["coeff_base"] = t  # [qctx][txsz][plane][ctx][4]
    assert list(t[0, 0, 0, 0][:3]) == icdf([4034, 8930, 12727])  # spec anchor
    t, end = take_table(d, end, (4, 5, 2, 21), 4)
    out["coeff_br"] = t  # [qctx][txsz][plane][ctx][4]

    # ---- EOB class CDFs, stored 1024 → 16, then eob_extra ----
    eob_off = find_u16_seq(d, icdf([393, 421, 751]))
    sizes = [("eob_pt_1024", 11), ("eob_pt_512", 10), ("eob_pt_256", 9),
             ("eob_pt_128", 8), ("eob_pt_64", 7), ("eob_pt_32", 6),
             ("eob_pt_16", 5)]
    off = eob_off
    for name, nsym in sizes:
        t, off = take_table(d, off, (4, 2, 2), nsym)
        out[name] = t  # [qctx][plane][ctx][nsym]
    t, off = take_table(d, off, (4, 5, 2, 9), 2)
    out["eob_extra"] = t  # [qctx][txsz][plane][ctx][2]

    # ---- txb_skip / dc_sign ----
    tsk_off = find_u16_seq(d, icdf([31849]) + [0, 0])
    t, _ = take_table(d, tsk_off, (4, 5, 13), 2)
    out["txb_skip"] = t  # [qctx][txsz][ctx][2]
    dcs_off = find_u16_seq(d, icdf([16000]) + [0, 0] + icdf([13056]))
    t, _ = take_table(d, dcs_off, (4, 2, 3), 2)
    out["dc_sign"] = t  # [qctx][plane][ctx][2]

    # ---- mode CDFs ----
    kfy_off = find_u16_seq(d, icdf([15588, 17027, 19338]))
    t, _ = take_table(d, kfy_off, (5, 5), 13)
    out["kf_y_mode"] = t  # [ctx_above][ctx_left][13]

    # uv mode, CfL-allowed variant (14 symbols)
    uvc_off = find_u16_seq(d, icdf([10407, 11208, 12900]))
    t, _ = take_table(d, uvc_off, (13,), 14)
    out["uv_mode_cfl"] = t
    # uv mode, CfL-not-allowed variant (13 symbols) — stored in the same
    # CDF_SIZE(14)=15-wide rows as the allowed variant (shared declaration
    # uv_mode_cdf[CFL_ALLOWED_TYPES][13][CDF_SIZE(14)]).
    uvn_off = find_u16_seq(d, icdf([22631, 24152, 25378]))
    t, _ = take_table(d, uvn_off, (13,), 13, stride=15)
    out["uv_mode"] = t

    # partition: one declaration partition_cdf[20][CDF_SIZE(10)=11]; rows
    # 0-3 = w8 (CDF4), 4-15 = w16/w32/w64 (CDF10), 16-19 = w128 (CDF8).
    p8_off = find_u16_seq(d, icdf([19132, 25510, 30392]))
    t, end = take_table(d, p8_off, (4,), 4, stride=11)
    out["partition_w8"] = t
    t, end = take_table(d, end, (4,), 10, stride=11)
    out["partition_w16"] = t
    assert list(t[0][:2]) == icdf([15597, 20929])
    t, end = take_table(d, end, (4,), 10, stride=11)
    out["partition_w32"] = t
    t, end = take_table(d, end, (4,), 10, stride=11)
    out["partition_w64"] = t
    t, end = take_table(d, end, (4,), 8, stride=11)
    out["partition_w128"] = t

    # skip flag: three CDF2 rows at stride 3 (the trailing counter of the
    # last row is elided by the next array's placement).
    skp_off = find_u16_seq(d, icdf([31671]) + [0, 0] + icdf([16515]))
    skip = np.zeros((3, 2), dtype=np.uint16)
    for c in range(3):
        skip[c, 0] = d[skp_off + 3 * c]
        assert d[skp_off + 3 * c + 1] == 0
    assert list(skip[:, 0]) == icdf([31671, 16515, 4576])  # spec anchor
    out["skip"] = skip

    # angle_delta[8] (directional modes), CDF7
    ang_off = find_u16_seq(d, icdf([2180, 5032, 7567]))
    t, _ = take_table(d, ang_off, (8,), 7)
    out["angle_delta"] = t

    # ---- CfL (chroma-from-luma) ----
    # joint-sign CDF8 (stored counter-less, packed tight against the alpha
    # table) immediately followed by alpha CDF16 x 6 contexts
    cfl_off = find_u16_seq(
        d, icdf([1418, 2123, 13340, 18405, 26972, 28343, 32294])
    )
    sign = d[cfl_off : cfl_off + 8].astype(np.uint16)
    assert sign[7] == 0 and np.all(sign[:6].astype(np.int64) > sign[1:7])
    out["cfl_sign"] = np.concatenate([sign[:7], [0]]).astype(np.uint16)
    t, _ = take_table(d, cfl_off + 8, (5,), 16)
    # Context 5: the on-disk blob contains a non-monotonic duplication
    # ("...355, 248, 355, 248, 174...") that cannot be a valid ICDF; the
    # spec/dav1d value set (monotonic, and equal to the blob minus the
    # duplicated pair) is used instead. Validated end-to-end by the
    # ctx-5-forcing CfL conformance test.
    row5 = np.array(
        [18030, 11090, 6989, 4867, 3744, 2466, 1788, 925, 624, 355, 248,
         174, 146, 112, 108, 0],
        dtype=np.uint16,
    )
    out["cfl_alpha"] = np.concatenate([t, row5[None]], axis=0)  # [6][16]
    assert out["cfl_alpha"][0][0] == 32768 - 7637  # spec anchor

    # intra_ext_tx: set1 [EXT_TX_SIZES=4][INTRA_MODES=13] CDF7 followed by
    # set2 [4][13] CDF5, both stored in CDF_SIZE(16)=17-wide rows. Located
    # by the set1[0][0] leading values (verified structurally: the only
    # 52-row run of 7-symbol stride-17 units in the blob).
    ext1_off = find_u16_seq(d, [31233, 24733, 23307, 20017, 9301, 4943, 0])
    t, _ = take_table(d, ext1_off, (4, 13), 7, stride=17)
    out["intra_ext_tx_set1"] = t
    t, _ = take_table(d, ext1_off + 52 * 17, (4, 13), 5, stride=17)
    out["intra_ext_tx_set2"] = t

    # ---- prediction weight tables ----
    # sm_weights (u8): concatenated arrays for bs 4,8,16,32,64; starts
    # 255,149,85,64 (bs4).
    db = d.view(np.uint8)
    sm_sig = np.array([255, 149, 85, 64, 255, 197], dtype=np.uint8)
    idxs = np.nonzero(db[: len(db) - 8] == 255)[0]
    sm_off = None
    for i in idxs:
        if np.array_equal(db[i : i + 6], sm_sig):
            sm_off = int(i)
            break
    assert sm_off is not None, "sm_weights not found"
    sm = db[sm_off : sm_off + 4 + 8 + 16 + 32 + 64].astype(np.int32)
    out["sm_weights_4"] = sm[0:4]
    out["sm_weights_8"] = sm[4:12]
    out["sm_weights_16"] = sm[12:28]
    out["sm_weights_32"] = sm[28:60]
    out["sm_weights_64"] = sm[60:124]
    assert out["sm_weights_8"][0] == 255 and out["sm_weights_64"][-1] >= 0

    # dr_intra_derivative (u16[90], nonzero at multiples of 3): signature
    # 1023 @3, 547 @6, 372 @9 with zeros between.
    dr_off = None
    for i in np.nonzero(d[: len(d) - 90] == 0)[0]:
        seg = d[i : i + 90]
        if (
            seg[1] == 0 and seg[2] == 0 and seg[3] == 1023
            and seg[6] == 547 and seg[9] == 372 and seg[87] > 0
        ):
            dr_off = int(i)
            break
    assert dr_off is not None, "dr_intra_derivative not found"
    out["dr_intra_derivative"] = d[dr_off : dr_off + 90].astype(np.int32)

    # ---- default (diagonal) scan tables ----
    # Stored as int16 permutations of 0..N-1. Located by permutation check.
    def find_scan(n, w):
        """Find a length-n u16 permutation that walks anti-diagonals of a
        w-wide block (the AV1 default scan)."""
        cand = np.nonzero(d[: len(d) - n] == 0)[0]
        for i in cand:
            seg = d[i : i + n]
            if seg[0] != 0 or seg[n - 1] != n - 1:
                continue
            s = np.sort(seg)
            if not np.array_equal(s, np.arange(n)):
                continue
            # verify anti-diagonal monotonicity: positions sorted by
            # (r+c) nondecreasing
            r, c = seg // w, seg % w
            diag = r + c
            if np.all(np.diff(diag.astype(np.int32)) >= 0):
                return seg.astype(np.int32)
        return None

    for name, n, w in [
        ("scan_4x4", 16, 4),
        ("scan_8x8", 64, 8),
        ("scan_16x16", 256, 16),
        ("scan_32x32", 1024, 32),
        # rect scans (round-4 rect-partition groundwork); validated by
        # the exact transpose relation between each wide/tall pair
        ("scan_4x8", 32, 4),
        ("scan_8x4", 32, 8),
        ("scan_8x16", 128, 8),
        ("scan_16x8", 128, 16),
        ("scan_16x32", 512, 16),
        ("scan_32x16", 512, 32),
    ]:
        s = find_scan(n, w)
        assert s is not None, f"{name} not found"
        out[name] = s
    for wide, tall, w_wide, w_tall in [
        ("scan_8x4", "scan_4x8", 8, 4),
        ("scan_16x8", "scan_8x16", 16, 8),
        ("scan_32x16", "scan_16x32", 32, 16),
    ]:
        t = out[tall]
        tp = (t % w_tall) * w_wide + (t // w_tall)
        assert np.array_equal(tp, out[wide]), (wide, tall)

    # ---- tx_size depth CDFs (av1_default_tx_size_cdf) ----
    # [MAX_TX_CATS=4][TX_SIZE_CONTEXTS=3][CDF_SIZE(3)=4]; cat 0 rows are
    # 2-symbol. Located by the cat-1 ICDF signature AOM_CDF3(12272, 30172).
    txs_off = find_u16_seq(
        d, [12800, 0, 0, 0, 12800, 0, 0, 0, 8448, 0, 0, 0, 20496, 2596]
    )
    txsz = d[txs_off : txs_off + 4 * 3 * 4].astype(np.uint16).reshape(4, 3, 4)
    assert txsz[3, 2, 0] == 15965 and txsz[2, 0, 1] == 17588
    out["tx_size"] = txsz[..., :3]  # drop the rodata pad column

    # ---- palette CDFs (spec 5.11.46-50 defaults) ----
    # anchored by the default_palette_y_size_cdf row-0 values; the
    # y/uv size tables are contiguous [7][8], the y_mode [7][3] run of
    # 2-symbol units sits after the uv_mode [2] pair (anchor: the
    # {31676, 3419, 1261} bsize-ctx row), and the color-index tables
    # are the only two [7][5][CDF_SIZE(8)]-padded arrays whose unit
    # pattern is five units each of 2..8 symbols.
    ysz_off = find_u16_seq(d, icdf([7952, 13000, 18149]))
    out["palette_y_size"] = take_table(d, ysz_off, (7,), 7, stride=8)[0]
    out["palette_uv_size"] = take_table(d, ysz_off + 56, (7,), 7, stride=8)[0]
    ym_off = find_u16_seq(d, icdf([31676]) + [0, 0] + icdf([3419]))

    def take_2sym_run(start, count):
        # 2-symbol units with tolerated alignment zeros between units
        vals, i = [], start
        while len(vals) < count:
            while d[i] == 0:
                i += 1
            v = int(d[i])
            assert 0 < v < 32768 and d[i + 1] == 0 and d[i + 2] == 0, (i, v)
            vals.append([v, 0])
            i += 3
        return np.asarray(vals, np.uint16)

    out["palette_y_mode"] = take_2sym_run(ym_off, 21).reshape(7, 3, 2)
    # palette_uv_mode: spec defaults AOM_CDF2(32461), AOM_CDF2(21488).
    # Row 0's icdf (307) appears as a standalone unit in rodata (u16
    # 46884); row 1 is not stored contiguously in this libaom build, so
    # the pair is pinned from the spec constants and validated by the
    # dav1d round-trip (a wrong value desyncs the arithmetic state —
    # tests/test_palette.py would fail on the first chroma-DC block).
    assert find_u16_seq(d, [32768 - 32461, 0, 0]) > 0
    out["palette_uv_mode"] = np.array(
        [[32768 - 32461, 0], [32768 - 21488, 0]], np.uint16)

    def find_color_index():
        want = []
        for s in range(2, 9):
            want += [s] * 5
        hits = []
        for off in range(0, len(d) - 35 * 9):
            if not (0 < d[off] < 32768 and d[off + 1] == 0):
                continue
            ok = True
            for u in range(35):
                o2 = off + u * 9
                vals = d[o2 : o2 + 9].astype(int)
                k = 0
                while k < 8 and 0 < vals[k] < 32768 and (
                    k == 0 or vals[k] < vals[k - 1]
                ):
                    k += 1
                if k + 1 != want[u] or np.any(vals[k:] != 0):
                    ok = False
                    break
            if ok:
                hits.append(off)
        assert len(hits) == 2, hits
        return hits

    # struct order puts the UV table FIRST in this build's rodata —
    # pinned empirically: with the first hit as Y, dav1d desyncs on any
    # mixed index map; swapped, every probe decodes bit-exactly (the Y
    # size-2 ctx-0 prob is 28710)
    ci_uv, ci_y = find_color_index()
    assert 32768 - d[ci_y] == 28710
    # per-size ragged tables stored as separate keys (each [5][nsym])
    for tag, base_off in (("y", ci_y), ("uv", ci_uv)):
        for si, nsym in enumerate(range(2, 9)):
            out[f"palette_{tag}_color_index_{nsym}"] = take_table(
                d, base_off + si * 45, (5,), nsym, stride=9
            )[0]

    # ---- filter-intra (spec 7.11.2.3 recursive filter + its two CDFs) ----
    # Taps: the only int8 [5][8][8] block in rodata whose every row of 8
    # sums to 16 (unit DC gain of the recursive filter). Row = one of the
    # 8 output pixels of a 4x2 patch; columns = refs p0..p6 + a zero pad.
    rod8 = load_rodata_bytes().view(np.int8)
    taps = find_filter_intra_taps(rod8)
    assert list(taps[0, 0]) == [-6, 10, 0, 0, 0, 12, 0, 0]  # anchor
    out["filter_intra_taps"] = taps
    # use_filter_intra CDF2 per block size: located by the exact probs of
    # the ten square/2:1 allowed sizes (4x4..32x32) stored as consecutive
    # 3-slot units; the 4:1 sizes follow after one uniform entry. The
    # disallowed sizes (>32) never code the symbol, so their rows are
    # pinned to the uniform 16384 (values validated end-to-end by the
    # dav1d conformance probes like every other CDF here).
    use_probs10 = [4621, 6743, 5893, 7866, 12551, 9394, 12408, 14301,
                   12756, 22343]
    ufi_off = find_u16_seq(
        d, sum([[32768 - p, 0, 0] for p in use_probs10], [])
    )
    probs41 = [32768 - int(d[ufi_off + 32 + 3 * k]) for k in range(4)]
    assert probs41 == [12770, 10368, 20229, 18101], probs41  # 4x16..32x8
    ufi = np.full(22, 16384, dtype=np.int64)
    ufi[0:10] = use_probs10
    ufi[16:20] = probs41
    out["filter_intra_use"] = np.stack(
        [(32768 - ufi).astype(np.uint16), np.zeros(22, dtype=np.uint16)],
        axis=1,
    )  # [22][2] icdf units
    # filter_intra_mode CDF5: the unit [23819, 19992, 15557, 3210] appears
    # byte-identically in BOTH libaom (whole file) and libdav1d .rodata —
    # probs (8949, 12776, 17211, 29558).
    fim = [23819, 19992, 15557, 3210]
    whole = np.fromfile(LIBAOM, dtype=np.uint8)
    pat = np.array(fim, dtype="<u2").tobytes()
    assert bytes(whole).find(pat) >= 0, "filter_intra_mode unit not found"
    out["filter_intra_mode"] = np.array(fim + [0], dtype=np.uint16)

    # ---- loop restoration (spec 5.11.31-32 read_lr defaults) ----
    # These three tiny CDFs are not locatable by structural signature:
    # libaom's copies hide among thousands of 3-u16 false matches and
    # libdav1d compiles them as IMMEDIATE stores in dav1d_cdf_init
    # (disassembly: `mov $0x52ce,%edi` -> [cdf+0x1508] restore_wiener,
    # `mov $0x3e29,%r10d` -> [+0x150c] restore_sgrproj, and a 4-byte
    # rodata load at .rodata+0x10604 -> [+0x1500] restore_switchable).
    # Values recovered from that disassembly and validated end-to-end:
    # streams coding these symbols decode bit-exactly through BOTH
    # system decoders (dav1d and libaom) in tests/test_restoration.py.
    out["wiener_restore"] = np.array([32768 - 11570, 0], dtype=np.uint16)
    out["sgrproj_restore"] = np.array([32768 - 16855, 0], dtype=np.uint16)
    out["switchable_restore"] = np.array(
        [32768 - 9413, 32768 - 22581, 0], dtype=np.uint16
    )

    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    total = sum(v.size for v in out.values())
    print(f"wrote {OUT} with {len(out)} tables, {total} values")
    for k, v in sorted(out.items()):
        print(f"  {k}: shape {v.shape}")


if __name__ == "__main__":
    main()

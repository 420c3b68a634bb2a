"""Loop restoration (Wiener) conformance: our syntax + filter vs dav1d.

Every stream here is crafted through the Python tile coder with an
explicit LR config, muxed, decoded by the system dav1d (via libavif),
and compared bit-exactly against our own reconstruction run through
oavif_jax.av1.restoration.apply_wiener — the same decode==recon
invariant the rest of the toolset is held to (SURVEY.md §4a).
Reference behavior: libaom's loop restoration behind
avifEncoderAddImage (reference src/io.zig:629-632).
"""

from __future__ import annotations

import numpy as np
import pytest

from oavif_jax.av1 import frame as frame_mod
from oavif_jax.av1.frame import TileEncoder
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream
from oavif_jax.av1.restoration import apply_wiener, count_units, unit_size


def _dav1d():
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    return decode_to_yuv


def _noise_planes(h, w, seed=11, bitdepth=8, amp=60):
    rng = np.random.default_rng(seed)
    mid = 1 << (bitdepth - 1)
    base = np.linspace(-amp, amp, w, dtype=np.float64)
    out = []
    for p in range(3):
        pl = (mid + base[None, :] * ((p % 2) * 2 - 1)
              + rng.integers(-amp, amp, (h, w)))
        out.append(np.clip(pl, 0, (1 << bitdepth) - 1).astype(np.int32))
    return out


def _roundtrip(planes, lr, qindex=60, bitdepth=8, unit_shift=2,
               cdef=None, flv=0):
    """Encode with the LR config; return (dav1d planes, our LR recon)."""
    h, w = planes[0].shape
    te = TileEncoder([p.copy() for p in planes], qindex, bitdepth, 9, lr=lr)
    payload = te.encode()
    recon = [r.copy() for r in te.recon]
    if flv:
        from oavif_jax.av1.loopfilter import loop_filter_frame

        loop_filter_frame(recon, te.blocks, (flv, flv, flv, flv),
                          bitdepth=bitdepth, visible=(h, w))
    deblk = [r.copy() for r in recon]
    if cdef is not None:
        from oavif_jax.av1.cdef import cdef_frame

        cdef_frame(recon, te.blocks, cdef[0], cdef[1], bitdepth)
    out = apply_wiener(recon, deblk, h, w, lr["types"], lr["unit_shift"],
                       lr["wiener"], bitdepth)
    seq = SequenceConfig(width=w, height=h, bit_depth=bitdepth,
                         enable_restoration=True,
                         enable_cdef=cdef is not None)
    fr = FrameConfig(
        width=w, height=h, base_q_idx=qindex,
        enable_restoration=True, lr_types=lr["types"],
        lr_unit_shift=lr["unit_shift"],
        filter_levels=(flv, flv, flv, flv),
        enable_cdef=cdef is not None,
        cdef_damping=cdef[1] if cdef else 3,
        cdef_strengths=(cdef[0],) if cdef else ((0, 0, 0, 0),),
    )
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), w, h,
                    bit_depth=bitdepth, high_bitdepth=bitdepth == 10)
    dec, _, _ = _dav1d()(data)
    return dec, out


def test_lr_identity_taps_decode_exact():
    """use_wiener=1 with (0,0,0) taps is the identity filter: validates
    the restoration-type CDF + subexp coding with zero filter risk."""
    planes = _noise_planes(32, 32)
    lr = {"types": (2, 0, 0), "unit_shift": 2,
          "wiener": {0: [[[0, 0, 0, 0, 0, 0]]]}}
    dec, ours = _roundtrip(planes, lr)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_wiener_single_stripe_exact():
    """48-row frame sits inside the first 56-row stripe: pure 7-tap
    separable filter semantics, no boundary logic."""
    planes = _noise_planes(48, 48, seed=5)
    lr = {"types": (2, 0, 0), "unit_shift": 2,
          "wiener": {0: [[[3, -7, 15, 3, -7, 15]]]}}
    dec, ours = _roundtrip(planes, lr)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_wiener_extreme_taps_exact():
    """Tap bounds exercise the long subexp paths both directions."""
    planes = _noise_planes(48, 48, seed=6)
    lr = {"types": (2, 0, 0), "unit_shift": 2,
          "wiener": {0: [[[-5, -23, -17, 10, 8, 46]]]}}
    dec, ours = _roundtrip(planes, lr)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_wiener_stripe_boundaries_and_cdef_exact():
    """192x160 frame, 64px units (3x3 RU grid), CDEF on: out-of-stripe
    support rows must come from the PRE-CDEF deblocked frame, limited to
    2 rows past the stripe edge — the spec get_source_sample sandwich."""
    planes = _noise_planes(160, 192, seed=7)
    size = unit_size(0)
    urows, ucols = count_units(160, size), count_units(192, size)
    rng = np.random.default_rng(3)
    grid = []
    for ur in range(urows):
        row = []
        for uc in range(ucols):
            if (ur + uc) % 3 == 2:
                row.append(None)  # use_wiener=0 units interleaved
            else:
                row.append([int(rng.integers(-5, 11)),
                            int(rng.integers(-23, 9)),
                            int(rng.integers(-17, 47)),
                            int(rng.integers(-5, 11)),
                            int(rng.integers(-23, 9)),
                            int(rng.integers(-17, 47))])
        grid.append(row)
    lr = {"types": (2, 0, 0), "unit_shift": 0, "wiener": {0: grid}}
    dec, ours = _roundtrip(planes, lr, qindex=70,
                           cdef=((4, 2, 4, 2), 3), flv=8)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_wiener_chroma_5tap_exact():
    """Chroma units never code tap 0 (firstCoeff=1): 5-tap filters on
    all three planes, distinct taps, with deblocking on."""
    planes = _noise_planes(96, 80, seed=9)
    lr = {
        "types": (2, 2, 2),
        "unit_shift": 2,
        "wiener": {
            0: [[[2, -5, 20, -1, 3, 30]]],
            1: [[[0, -9, 25, 0, 4, 18]]],
            2: [[[0, 6, 12, 0, -11, 40]]],
        },
    }
    dec, ours = _roundtrip(planes, lr, qindex=80, flv=6)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_wiener_10bit_exact():
    planes = _noise_planes(64, 64, seed=13, bitdepth=10, amp=240)
    lr = {"types": (2, 0, 0), "unit_shift": 2,
          "wiener": {0: [[[3, -7, 15, -2, 4, 28]]]}}
    dec, ours = _roundtrip(planes, lr, qindex=90, bitdepth=10)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_lr_c_python_byte_identity():
    """The C tile coder mirrors the LR unit syntax byte-for-byte
    (subexp refs, chroma firstCoeff, unit iteration)."""
    from oavif_jax.av1.entropy.fast import get_lib, tile_encode_native

    if get_lib() is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(9)
    h, w = 160, 192
    planes = [np.asarray(128 + rng.integers(-70, 70, (h, w)), np.int32)
              for _ in range(3)]
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    grid = {}
    for p in range(3):
        g = []
        for ur in range(urows):
            row = []
            for uc in range(ucols):
                if (ur + uc + p) % 3 == 0:
                    row.append(None)
                    continue
                t6 = [int(rng.integers(-5, 11)), int(rng.integers(-23, 9)),
                      int(rng.integers(-17, 47)), int(rng.integers(-5, 11)),
                      int(rng.integers(-23, 9)), int(rng.integers(-17, 47))]
                if p:
                    t6[0] = t6[3] = 0
                row.append(t6)
            g.append(row)
        grid[p] = g
    lr = {"types": (2, 2, 2), "unit_shift": 0, "wiener": grid}
    for q in (40, 120):
        te = TileEncoder([p.copy() for p in planes], q, 8, 9, lr=lr)
        py = te.encode()
        res = tile_encode_native([p.copy() for p in planes], q, 8, 9,
                                 None, 0, lr=lr)
        assert res is not None
        assert res[0] == py
        for a, b in zip(res[1], te.recon):
            np.testing.assert_array_equal(a, b)


def test_lr_c_python_byte_identity_mixed_types():
    """The C coder mirrors the FULL restoration syntax byte-for-byte:
    SWITCHABLE's 3-ary unit type, SGR set/xqd subexp (refs mid
    {-32, 31}, radius-0 ref pinning), Wiener taps — across frame types
    (1, 3, 2) on the three planes."""
    from oavif_jax.av1.entropy.fast import get_lib, tile_encode_native

    if get_lib() is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(9)
    h, w = 160, 192
    planes = [np.asarray(128 + rng.integers(-70, 70, (h, w)), np.int32)
              for _ in range(3)]
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    wcfg, scfg = {}, {}
    for p in range(3):
        wg = [[None] * ucols for _ in range(urows)]
        sg = [[None] * ucols for _ in range(urows)]
        k = p
        for ur in range(urows):
            for uc in range(ucols):
                m = k % 3
                k += 1
                if m == 0 and p != 1:
                    t6 = [2, -5, 20, -1, 3, 30]
                    if p:
                        t6[0] = t6[3] = 0
                    wg[ur][uc] = t6
                elif m == 1 and p != 2:
                    sg[ur][uc] = ((9, -33, 52), (12, 0, 0), (14, -70, 95),
                                  (0, 31, -32))[(ur + uc) % 4]
        wcfg[p] = wg
        scfg[p] = sg
    lr = {"types": (1, 3, 2), "unit_shift": 0, "wiener": wcfg,
          "sgrproj": scfg}
    for q in (40, 120):
        te = TileEncoder([p.copy() for p in planes], q, 8, 9, lr=lr)
        py = te.encode()
        res = tile_encode_native([p.copy() for p in planes], q, 8, 9,
                                 None, 0, lr=lr)
        assert res is not None
        assert res[0] == py
        for a, b in zip(res[1], te.recon):
            np.testing.assert_array_equal(a, b)


def test_lr_sgr_product_path_decodes_exact():
    """encode_avif_with_recon at speed 5 (SGRPROJ joins the joint LR
    search): shipped bytes decode (dav1d) to exactly the recon the TQ
    loop scored — SGR meets the product invariant since the xqd ref-mid
    fix."""
    import os
    import types as pytypes

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.av1.yuv import yuv444_to_rgb

    rng = np.random.default_rng(5)
    x = np.linspace(0, 6, 160)
    img = np.clip(
        128 + 60 * np.sin(x[None, :] * 3 + x[:, None] * 2)[..., None]
        * np.ones(3) + rng.normal(0, 12, (160, 160, 3)), 0, 255
    ).astype(np.uint8)
    src = pytypes.SimpleNamespace(data=img, channels=3, hbd=False, icc=None)
    o_env = os.environ.get("OAVIF_LR")
    os.environ["OAVIF_LR"] = "1"
    try:
        from oavif_jax.options import EncOptions

        o = EncOptions()
        o.speed = 5
        ctx = pytypes.SimpleNamespace(o=o, src=src, q=70)
        data, recon = encode_avif_with_recon(ctx)
    finally:
        if o_env is None:
            os.environ.pop("OAVIF_LR", None)
        else:
            os.environ["OAVIF_LR"] = o_env
    yuv, depth, _ = _dav1d()(data)
    dec_rgb = yuv444_to_rgb([p for p in yuv], bitdepth=depth)
    np.testing.assert_array_equal(dec_rgb, recon)


def test_lr_product_path_decodes_exact():
    """encode_avif_with_recon with LR armed: shipped bytes decode
    (dav1d) to exactly the recon the TQ loop scored."""
    import os
    import types as pytypes

    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.av1.yuv import yuv444_to_rgb

    rng = np.random.default_rng(5)
    x = np.linspace(0, 6, 160)
    img = np.clip(
        128 + 60 * np.sin(x[None, :] * 3 + x[:, None] * 2)[..., None]
        * np.ones(3) + rng.normal(0, 12, (160, 160, 3)), 0, 255
    ).astype(np.uint8)
    src = pytypes.SimpleNamespace(data=img, channels=3, hbd=False, icc=None)
    o_env = os.environ.get("OAVIF_LR")
    os.environ["OAVIF_LR"] = "1"
    try:
        from oavif_jax.options import EncOptions

        o = EncOptions()
        o.speed = 6
        ctx = pytypes.SimpleNamespace(o=o, src=src, q=70)
        data, recon = encode_avif_with_recon(ctx)
    finally:
        if o_env is None:
            os.environ.pop("OAVIF_LR", None)
        else:
            os.environ["OAVIF_LR"] = o_env
    yuv, depth, _ = _dav1d()(data)
    dec_rgb = yuv444_to_rgb([p for p in yuv], bitdepth=depth)
    np.testing.assert_array_equal(dec_rgb, recon)


def _sgr_roundtrip(planes, set_idx, w0, w1, q=60):
    from oavif_jax.av1.restoration import apply_sgrproj

    n_h, n_w = planes[0].shape
    lr = {"types": (3, 0, 0), "unit_shift": 2,
          "sgrproj": {0: [[(set_idx, w0, w1)]]}}
    te = TileEncoder([p.copy() for p in planes], q, 8, 9, lr=lr)
    payload = te.encode()
    seq = SequenceConfig(width=n_w, height=n_h, enable_restoration=True)
    fr = FrameConfig(width=n_w, height=n_h, base_q_idx=q,
                     enable_restoration=True, lr_types=(3, 0, 0),
                     lr_unit_shift=2)
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), n_w, n_h)
    dec, _, _ = _dav1d()(data)
    recon = [r.copy() for r in te.recon]
    ours = apply_sgrproj(recon, [r.copy() for r in recon], n_h, n_w,
                         (3, 0, 0), 2, {0: [[(set_idx, w0, w1)]]}, 8)
    for i in (1, 2):
        np.testing.assert_array_equal(dec[i], te.recon[i][:n_h, :n_w])
    return dec[0].astype(int), ours[0]


def test_sgrproj_all_sets_decode_exact():
    """SGRPROJ units (spec 5.11.34 + 7.17.3): syntax (4-bit set, subexp
    xqd with mid {-32, 31}, radius-gated weights) and the self-guided
    filter, bit-exact vs dav1d for ALL 16 parameter sets at
    representative weights. The pinned facts: libdav1d's strength table
    verbatim, the x_by_x mapping, the odd-row r=2 A/B grid with 5/6 and
    3/4 cross-sums, av1_decode_xq's COMPLEMENTED r=1 weight
    (xq1 = 128 - xq0 - xqd[1] whenever pass 1 runs), and the
    C-TRUNCATED xqd ref mids ((-32+95)/2 = 31, NOT 32 — a 32 mid makes
    decoders read every xqd[1] one low, visible only at rounding
    boundaries)."""
    rng = np.random.default_rng(3)
    planes = [np.asarray(128 + rng.integers(-60, 60, (48, 48)), np.int32)
              for _ in range(3)]
    from oavif_jax.av1.restoration import SGR_PARAMS

    for s in range(16):
        r0, _, r1, _ = SGR_PARAMS[s]
        w0 = -33 if r0 else 0
        w1 = 52 if r1 else 95
        dec, ours = _sgr_roundtrip(planes, s, w0, w1)
        np.testing.assert_array_equal(dec, ours, err_msg=f"set {s}")


def test_sgrproj_weight_grid_exact():
    """The whole coded weight space is bit-exact vs dav1d — interior
    combinations, the w1=0 extreme (effective xq1 = 128, where the old
    off-by-one xqd ref mid showed as dense 'plateau' diffs), and the
    corner weights with complement past 128 like (31, -32)."""
    for seed, set_idx, w0, w1 in ((7, 9, -33, 52), (11, 6, -20, 40),
                                  (11, 9, -33, 52), (5, 4, 10, 64),
                                  (7, 12, 0, 0), (3, 12, 0, 1),
                                  (3, 0, 31, -32), (9, 14, -70, 95),
                                  (13, 0, -96, 90), (13, 3, 31, 60)):
        rng = np.random.default_rng(seed)
        planes = [np.asarray(128 + rng.integers(-60, 60, (64, 64)),
                             np.int32) for _ in range(3)]
        dec, ours = _sgr_roundtrip(planes, set_idx, w0, w1)
        np.testing.assert_array_equal(
            dec, ours, err_msg=f"seed {seed} set {set_idx} ({w0},{w1})")


def test_sgrproj_multi_unit_ref_chain_exact():
    """Several SGR units per plane with distinct weights: the xqd
    subexp refs chain across units (spec: ref takes the coded value;
    radius-0 passes pin 0 / 95) — any ref drift desyncs or shifts the
    decoded weights."""
    from oavif_jax.av1.restoration import apply_sgrproj, count_units, \
        unit_size

    rng = np.random.default_rng(17)
    h, w = 160, 192
    planes = [np.asarray(128 + rng.integers(-60, 60, (h, w)), np.int32)
              for _ in range(3)]
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    entries = [(0, -33, 52), (9, 10, 64), (12, 0, 0), None, (14, -70, 95),
               (5, 31, -32), (11, 0, 95), (3, -96, 90), (7, 5, 5)]
    grid = [[entries[(ur * ucols + uc) % len(entries)]
             for uc in range(ucols)] for ur in range(urows)]
    lr = {"types": (3, 0, 0), "unit_shift": 0, "sgrproj": {0: grid}}
    te = TileEncoder([p.copy() for p in planes], 60, 8, 9, lr=lr)
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, enable_restoration=True)
    fr = FrameConfig(width=w, height=h, base_q_idx=60,
                     enable_restoration=True, lr_types=(3, 0, 0),
                     lr_unit_shift=0)
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), w, h)
    dec, _, _ = _dav1d()(data)
    recon = [r.copy() for r in te.recon]
    ours = apply_sgrproj(recon, [r.copy() for r in recon], h, w,
                         (3, 0, 0), 0, {0: grid}, 8)
    np.testing.assert_array_equal(dec[0], ours[0])


def test_lr_switchable_mixed_units_decode_exact():
    """SWITCHABLE frame type (coded 1): per-unit restoration type from
    the 3-ary switchable_restore CDF, Wiener and SGR units interleaved
    with NONE, both families' refs chaining — on all three planes."""
    from oavif_jax.av1.restoration import apply_restoration, \
        count_units, unit_size

    rng = np.random.default_rng(11)
    h, w = 160, 192
    planes = [np.asarray(128 + rng.integers(-60, 60, (h, w)), np.int32)
              for _ in range(3)]
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    wcfg, scfg = {}, {}
    for p in range(3):
        wg = [[None] * ucols for _ in range(urows)]
        sg = [[None] * ucols for _ in range(urows)]
        k = p
        for ur in range(urows):
            for uc in range(ucols):
                m = k % 3
                k += 1
                if m == 0:
                    t6 = [2, -5, 20, -1, 3, 30]
                    if p:
                        t6[0] = t6[3] = 0
                    wg[ur][uc] = t6
                elif m == 1:
                    sg[ur][uc] = ((9, -33, 52), (12, 0, 0),
                                  (14, -70, 95))[(ur + uc) % 3]
        wcfg[p] = wg
        scfg[p] = sg
    types = (1, 1, 1)
    lr = {"types": types, "unit_shift": 0, "wiener": wcfg,
          "sgrproj": scfg}
    te = TileEncoder([p.copy() for p in planes], 60, 8, 9, lr=lr)
    payload = te.encode()
    seq = SequenceConfig(width=w, height=h, enable_restoration=True)
    fr = FrameConfig(width=w, height=h, base_q_idx=60,
                     enable_restoration=True, lr_types=types,
                     lr_unit_shift=0)
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), w, h)
    dec, _, _ = _dav1d()(data)
    recon = [r.copy() for r in te.recon]
    ours = apply_restoration(recon, [r.copy() for r in recon], h, w,
                             types, 0, wcfg, scfg, 8)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], ours[i])


def test_search_restoration_joint_decode_exact():
    """The joint WIENER/SGR/NONE search: picks per-unit winners on
    quantization-degraded content, the chosen config reduces SSE, and
    the coded stream decodes (dav1d) bit-exactly to apply_restoration's
    output — the product invariant SGRPROJ now meets."""
    from oavif_jax.av1.restoration import apply_restoration, \
        search_restoration

    rng = np.random.default_rng(4)
    h = w = 192
    x = np.linspace(0, 8, w)
    base = 128 + 70 * np.sin(x[None, :] * 2 + x[:, None] * 1.3)
    planes = [np.clip(base + rng.normal(0, 10, (h, w)), 0,
                      255).astype(np.int32) for _ in range(3)]
    q = 140
    te = TileEncoder([p.copy() for p in planes], q, 8, 9)
    te.encode()
    recon = [r[:h, :w].copy() for r in te.recon]
    deblk = [r.copy() for r in recon]
    types, wcfg, scfg = search_restoration(planes, recon, deblk, h, w,
                                           8, lam_pix=1.4, unit_shift=1)
    assert types is not None and any(types)
    out = apply_restoration(recon, deblk, h, w, types, 1, wcfg, scfg, 8)
    sse0 = sum(float(np.square(p[:h, :w].astype(np.int64) - r).sum())
               for p, r in zip(planes, recon))
    sse1 = sum(float(np.square(p[:h, :w].astype(np.int64) - o).sum())
               for p, o in zip(planes, out))
    assert sse1 < sse0
    lr = {"types": types, "unit_shift": 1, "wiener": wcfg,
          "sgrproj": scfg}
    te2 = TileEncoder([p.copy() for p in planes], q, 8, 9, lr=lr)
    payload = te2.encode()
    seq = SequenceConfig(width=w, height=h, enable_restoration=True)
    fr = FrameConfig(width=w, height=h, base_q_idx=q,
                     enable_restoration=True, lr_types=types,
                     lr_unit_shift=1)
    data = mux_avif(assemble_av1_stream(seq, fr, [payload]), w, h)
    dec, _, _ = _dav1d()(data)
    for i in range(3):
        np.testing.assert_array_equal(dec[i], out[i])


def test_lr_search_improves_sse():
    """Encoder-side tap solve: on quantization-degraded content the
    searched Wiener filter must reduce SSE vs the unfiltered recon
    whenever it elects to restore (it restores on this content)."""
    from oavif_jax.av1.restoration import search_wiener

    planes = _noise_planes(128, 128, seed=21, amp=40)
    te = TileEncoder([p.copy() for p in planes], 150, 8, 9)
    te.encode()
    recon = [r[:128, :128].copy() for r in te.recon]
    deblk = [r.copy() for r in recon]
    types, taps = search_wiener(planes, recon, deblk, 128, 128, 8,
                                lam_pix=1.0)
    assert types is not None and types[0] == 2
    out = apply_wiener(recon, deblk, 128, 128, types, 2, taps, 8)
    sse0 = sum(float(np.square(p[:128, :128].astype(np.int64) - r).sum())
               for p, r in zip(planes, recon))
    sse1 = sum(float(np.square(p[:128, :128].astype(np.int64) - o).sum())
               for p, o in zip(planes, out))
    assert sse1 < sse0

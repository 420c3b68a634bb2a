"""Model decoder for CodedLossless AV1 intra tiles (our toolset subset).

Decodes a tile payload produced by ANY conformant encoder restricted to:
square NONE/SPLIT partitions, no palette/filter-intra/intrabc, 4:4:4 or
monochrome, CodedLossless (tx 4x4 WHT). Used to debug our encoder's
bitstream semantics against libaom ground-truth streams: decode aom's
lossless tile with THIS model — the first divergence from the source image
localizes a misunderstanding in our symbol/context model (the encoder and
this decoder share all tables and context code).

Usage: tools/test flow in tests/test_lossless.py; also importable.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oavif_jax.av1.consts import (  # noqa: E402
    DC_PRED, INTRA_MODE_CONTEXT, MODE_TO_ANGLE, UV_CFL_PRED, coeff_q_ctx,
)
from oavif_jax.av1.entropy.rangecoder import RangeDecoder, update_cdf  # noqa: E402
from oavif_jax.av1.frame import CdfBank, TileEncoder  # noqa: E402
from oavif_jax.av1.intra import build_edges, predict  # noqa: E402
from oavif_jax.av1.tables import TABLES, ac_q, dc_q  # noqa: E402
from oavif_jax.av1.transform import inv_wht4x4  # noqa: E402

PARTITION_NONE, PARTITION_SPLIT = 0, 3


class LosslessTileDecoder:
    def __init__(self, payload: bytes, w: int, h: int, nplanes: int = 3,
                 bitdepth: int = 8, trace: bool = False) -> None:
        self.dec = RangeDecoder(payload)
        self.w, self.h = w, h
        self.nplanes = nplanes
        self.bitdepth = bitdepth
        self.trace = trace
        self.mi_cols = 2 * ((w + 7) >> 3)
        self.mi_rows = 2 * ((h + 7) >> 3)
        self.sb_cols = (self.mi_cols + 15) >> 4
        self.sb_rows = (self.mi_rows + 15) >> 4
        self.cdf = CdfBank(coeff_q_ctx(0))
        self.scan4 = TABLES["scan_4x4"].astype(np.int32)
        pw, ph = self.mi_cols * 4, self.mi_rows * 4
        self.recon = [np.zeros((ph, pw), np.int32) for _ in range(nplanes)]
        self.pw = pw
        # context lines (mirror TileEncoder)
        self.above_part = np.zeros(self.mi_cols, np.uint8)
        self.left_part = np.zeros(16, np.uint8)
        self.above_skip = np.zeros(self.mi_cols, np.uint8)
        self.left_skip = np.zeros(16, np.uint8)
        self.above_mode = np.full(self.mi_cols, DC_PRED, np.uint8)
        self.left_mode = np.full(16, DC_PRED, np.uint8)
        self.above_lvl = [np.zeros(self.mi_cols, np.int32) for _ in range(nplanes)]
        self.left_lvl = [np.zeros(16, np.int32) for _ in range(nplanes)]
        self.above_dc = [np.zeros(self.mi_cols, np.int32) for _ in range(nplanes)]
        self.left_dc = [np.zeros(16, np.int32) for _ in range(nplanes)]
        self.dq = dc_q(0, bitdepth)
        self.log = []

    # --- symbol helpers ---
    def _sym(self, row, nsym=None):
        nsym = nsym if nsym is not None else len(row) - 1
        s = self.dec.decode_symbol(row, nsym)
        update_cdf(row, s, nsym)
        return s

    # --- partition ---
    def decode(self):
        for sb_r in range(self.sb_rows):
            self.left_part[:] = 0
            self.left_skip[:] = 0
            self.left_mode[:] = DC_PRED
            for p in range(self.nplanes):
                self.left_lvl[p][:] = 0
                self.left_dc[p][:] = 0
            for sb_c in range(self.sb_cols):
                self._partition(sb_r * 16, sb_c * 16, 64)
        return [r[: self.h, : self.w] for r in self.recon]

    def _part_ctx(self, r, c, size):
        bsl = {8: 0, 16: 1, 32: 2, 64: 3}[size]
        return (((int(self.left_part[r & 15]) >> bsl) & 1) * 2
                + ((int(self.above_part[c]) >> bsl) & 1))

    def _partition(self, r, c, size):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        half = size // 8
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        if has_rows and has_cols:
            ctx = self._part_ctx(r, c, size)
            cdf = self.cdf.partition[size][ctx]
            part = self._sym(cdf)
            if self.trace:
                self.log.append(("part", r, c, size, part))
            assert part in (PARTITION_NONE, PARTITION_SPLIT), (
                f"rect partition {part} at {r},{c},{size} unsupported")
        elif not has_rows and not has_cols:
            part = PARTITION_SPLIT
        else:
            # split_or_horz / split_or_vert bool — model: always split
            ctx = self._part_ctx(r, c, size)
            cdf = self.cdf.partition[size][ctx]
            widths = []
            prev = 32768
            nsym = len(cdf) - 1
            for s in range(nsym):
                widths.append(prev - int(cdf[s]))
                prev = int(cdf[s])
            members = (2, 3, 4, 6, 7, 9) if has_cols else (1, 3, 4, 5, 6, 8)
            psum = sum(widths[m] for m in members if m < nsym)
            derived = np.array([psum, 0, 0], np.uint16)
            bit = self.dec.decode_symbol(derived, 2)
            assert bit == 1, "partial node coded non-split"
            part = PARTITION_SPLIT
        if part == PARTITION_SPLIT:
            sub = size // 2
            if size == 8:  # children are 4x4 blocks, no partition symbols
                for dr in (0, 1):
                    for dc in (0, 1):
                        if r + dr < self.mi_rows and c + dc < self.mi_cols:
                            self._block(r + dr, c + dc, 4)
                            self.above_part[c + dc] = 31
                            self.left_part[(r + dr) & 15] = 31
                return
            self._partition(r, c, sub)
            self._partition(r, c + half, sub)
            self._partition(r + half, c, sub)
            self._partition(r + half, c + half, sub)
        else:
            self._block(r, c, size)
            nm = size // 4
            byte = {8: 30, 16: 28, 32: 24, 64: 16}[size]
            self.above_part[c : c + nm] = byte
            self.left_part[(r & 15) : (r & 15) + nm] = byte

    def _edge_counts(self, r, c, size):
        n_mi = size // 4
        def has_tr(rr, cc, n):
            sz = n
            while sz < 16:
                parent = sz * 2
                top = (rr % parent) < sz
                left = (cc % parent) < sz
                if left:
                    return True
                if not top:
                    return False
                sz = parent
            return rr > 0 and ((cc | 15) + 1) < self.mi_cols
        def has_bl(rr, cc, n):
            sz = n
            while sz < 16:
                parent = sz * 2
                top = (rr % parent) < sz
                left = (cc % parent) < sz
                if top and left:
                    return cc > 0
                if top or not left:
                    return False
                sz = parent
            return False
        ntr = nbl = 0
        if has_tr(r, c, n_mi):
            ntr = max(0, min(size, (self.mi_cols - c - n_mi) * 4))
        if has_bl(r, c, n_mi):
            nbl = max(0, min(size, (self.mi_rows - r - n_mi) * 4))
        return ntr, nbl

    # --- block ---
    def _block(self, r, c, size):
        x, y = c * 4, r * 4
        nm = size // 4
        lr = r & 15
        skip_ctx = int(self.above_skip[c]) + int(self.left_skip[lr])
        skip = self._sym(self.cdf.skip[skip_ctx])
        actx = INTRA_MODE_CONTEXT[int(self.above_mode[c])] if r > 0 else 0
        lctx = INTRA_MODE_CONTEXT[int(self.left_mode[lr])] if c > 0 else 0
        y_mode = self._sym(self.cdf.kf_y[actx][lctx])
        y_delta = 0
        if y_mode in MODE_TO_ANGLE and size >= 8:
            y_delta = self._sym(self.cdf.angle_delta[y_mode - 1]) - 3
        uv_mode = DC_PRED
        uv_delta = 0
        cfl = (0, 0)
        if self.nplanes > 1:
            cfl_allowed = size <= 32
            cdf = self.cdf.uv_mode_cfl if cfl_allowed else self.cdf.uv_mode
            uv_mode = self._sym(cdf[y_mode])
            if uv_mode == UV_CFL_PRED:
                joint = self._sym(self.cdf.cfl_sign, 8)
                sign_u = (joint + 1) // 3
                sign_v = (joint + 1) % 3
                au = av = 0
                if sign_u:
                    idx = self._sym(self.cdf.cfl_alpha[joint - 2], 16)
                    au = (idx + 1) * (1 if sign_u == 2 else -1)
                if sign_v:
                    idx = self._sym(
                        self.cdf.cfl_alpha[sign_v * 3 + sign_u - 3], 16)
                    av = (idx + 1) * (1 if sign_v == 2 else -1)
                cfl = (au, av)
            elif uv_mode in MODE_TO_ANGLE and size >= 8:
                uv_delta = self._sym(self.cdf.angle_delta[uv_mode - 1]) - 3
        if self.trace:
            self.log.append(("block", r, c, size, skip, y_mode, uv_mode, cfl))

        hi = (1 << self.bitdepth) - 1
        ntr, nbl = self._edge_counts(r, c, size)
        for plane in range(self.nplanes):
            mode = y_mode if plane == 0 else uv_mode
            delta = y_delta if plane == 0 else uv_delta
            for ty in range(y, y + size, 4):
                for tx in range(x, x + size, 4):
                    above, left = build_edges(
                        self.recon[plane], tx, ty, 4, 4, ty > 0, tx > 0,
                        self.bitdepth, num_top_right=ntr,
                        num_bottom_left=nbl)
                    if plane > 0 and uv_mode == UV_CFL_PRED:
                        pred = predict(DC_PRED, above, left, 4, 4, ty > 0,
                                       tx > 0, bitdepth=self.bitdepth)
                        luma = self.recon[0][ty : ty + 4, tx : tx + 4].astype(
                            np.int64) << 3
                        avg = (int(luma.sum()) + 8) >> 4
                        diff = luma - avg
                        a = cfl[plane - 1]
                        prod = a * diff
                        contrib = np.sign(prod) * ((np.abs(prod) + 32) >> 6)
                        pred = np.clip(pred + contrib, 0, hi)
                    else:
                        pred = predict(mode, above, left, 4, 4, ty > 0,
                                       tx > 0, angle_delta=delta,
                                       bitdepth=self.bitdepth)
                    if skip:
                        self._set_lvl(plane, tx, ty, 0, 0)
                        rec = pred
                    else:
                        lv = self._coeffs(plane, tx, ty, size)
                        deq = (np.abs(lv) * self.dq) & 0xFFFFFF
                        resid = inv_wht4x4(np.sign(lv) * deq)
                        rec = np.clip(pred + resid, 0, hi)
                    self.recon[plane][ty : ty + 4, tx : tx + 4] = rec

        self.above_skip[c : c + nm] = skip
        self.left_skip[lr : lr + nm] = skip
        self.above_mode[c : c + nm] = y_mode
        self.left_mode[lr : lr + nm] = y_mode

    # --- coefficients (4x4, mirrors frame.py _encode_coeffs inverse) ---
    def _set_lvl(self, plane, px, py, cul, dc_cat):
        mi_c, mi_r = px // 4, py // 4
        self.above_lvl[plane][mi_c] = cul
        self.left_lvl[plane][mi_r & 15] = cul
        self.above_dc[plane][mi_c] = dc_cat
        self.left_dc[plane][mi_r & 15] = dc_cat

    def _txb_skip_ctx(self, plane, px, py, bsize):
        if plane == 0:
            if bsize == 4:
                return 0
            mi_c, mi_r = px // 4, py // 4
            top = int(self.above_lvl[0][mi_c]) & 63
            left = int(self.left_lvl[0][mi_r & 15]) & 63
            mx = min(top | left, 4)
            mn = min(min(top, left), 4)
            return int(TileEncoder._SKIP_CTX_TABLE[mn][mx])
        mi_c, mi_r = px // 4, py // 4
        above_nz = self.above_lvl[plane][mi_c] != 0
        left_nz = self.left_lvl[plane][mi_r & 15] != 0
        offset = 7 if bsize == 4 else 10
        return offset + int(above_nz) + int(left_nz)

    def _dc_sign_ctx(self, plane, px, py):
        mi_c, mi_r = px // 4, py // 4
        cats = [int(self.above_dc[plane][mi_c]),
                int(self.left_dc[plane][mi_r & 15])]
        bal = sum((c == 2) - (c == 1) for c in cats)
        return 1 if bal < 0 else (2 if bal > 0 else 0)

    def _coeffs(self, plane, px, py, bsize):
        ptype = 0 if plane == 0 else 1
        ctx = self._txb_skip_ctx(plane, px, py, bsize)
        all_zero = self._sym(self.cdf.txb_skip[0][ctx])
        if self.trace:
            self.log.append(("txb", plane, px, py, ctx, all_zero))
        if all_zero:
            self._set_lvl(plane, px, py, 0, 0)
            return np.zeros((4, 4), np.int64)
        # no tx_type in lossless
        eob_pt = self._sym(self.cdf.eob_pt[16][ptype][0]) + 1
        if eob_pt == 1:
            eob = 1
        elif eob_pt == 2:
            eob = 2
        else:
            nbits = eob_pt - 2
            msb = self._sym(self.cdf.eob_extra[0][ptype][eob_pt - 3])
            rest = msb << (nbits - 1)
            for i in range(nbits - 2, -1, -1):
                rest |= self.dec.decode_bool_q15(16384) << i
            eob = (1 << (eob_pt - 2)) + rest + 1
        lv = np.zeros(16, np.int64)
        pad = np.zeros((6, 6), np.int64)
        scan = self.scan4
        for si in range(eob - 1, -1, -1):
            pos = int(scan[si])
            rr, cc = pos >> 2, pos & 3
            if si == eob - 1:
                if si == 0:
                    ce = 0
                elif si <= 2:
                    ce = 1
                elif si <= 4:
                    ce = 2
                else:
                    ce = 3
                level = self._sym(self.cdf.coeff_base_eob[0][ptype][ce]) + 1
            else:
                mag = (min(int(pad[rr, cc + 1]), 3) + min(int(pad[rr + 1, cc]), 3)
                       + min(int(pad[rr + 1, cc + 1]), 3)
                       + min(int(pad[rr, cc + 2]), 3)
                       + min(int(pad[rr + 2, cc]), 3))
                mag = min((mag + 1) >> 1, 4)
                if pos == 0:
                    bctx = 0
                elif rr + cc < 2:
                    bctx = mag + 1
                elif rr + cc < 4:
                    bctx = mag + 6
                else:
                    bctx = mag + 21
                level = self._sym(self.cdf.coeff_base[0][ptype][bctx])
            if level > 2:
                magb = (min(int(pad[rr, cc + 1]), 15)
                        + min(int(pad[rr + 1, cc]), 15)
                        + min(int(pad[rr + 1, cc + 1]), 15))
                magb = min((magb + 1) >> 1, 6)
                if pos == 0:
                    brctx = magb
                elif rr < 2 and cc < 2:
                    brctx = magb + 7
                else:
                    brctx = magb + 14
                for _ in range(4):
                    k = self._sym(self.cdf.coeff_br[0][ptype][brctx])
                    level += k
                    if k < 3:
                        break
            lv[pos] = level
            pad[rr, cc] = min(level, 127)
        # signs + golomb
        cul = 0
        dc_cat = 0
        for si in range(eob):
            pos = int(scan[si])
            level = int(lv[pos])
            if level == 0:
                continue
            if si == 0:
                sctx = self._dc_sign_ctx(plane, px, py)
                sign = self._sym(self.cdf.dc_sign[ptype][sctx])
                dc_cat = 1 if sign else 2
            else:
                sign = self.dec.decode_bool_q15(16384)
            if level > 14:
                n = 0
                while self.dec.decode_bool_q15(16384) == 0:
                    n += 1
                xv = 1
                for _ in range(n):
                    xv = (xv << 1) | self.dec.decode_bool_q15(16384)
                level = (xv - 1) + 15
                lv[pos] = level
            cul += level
            if sign:
                lv[pos] = -level
        self._set_lvl(plane, px, py, min(cul, 63), dc_cat)
        return lv.reshape(4, 4)

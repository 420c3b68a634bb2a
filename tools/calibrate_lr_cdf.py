"""One-time calibration: recover the default wiener_restore CDF prob.

The AV1 spec's default CDF for the per-restoration-unit use_wiener symbol
could not be located structurally in the stripped system libaom/libdav1d
rodata (the bool-CDF units are 3 u16 wide — thousands of false matches).
This tool recovers it empirically with dav1d as the oracle, the same
decoder-validated methodology every other syntax element in this repo
used (tests/test_conformance.py):

  * craft a noisy 32x32 single-RU frame, FrameRestorationType = WIENER
    on luma, use_wiener = 1, taps = (0,0,0)/(0,0,0) — the IDENTITY
    Wiener filter (center tap 128), so the loop-restoration output
    equals its input and the expected decode equals the plain recon;
  * encode the stream with a CANDIDATE probability for the symbol;
  * dav1d decodes bit-exactly iff the candidate equals its default:
    any mismatch changes the range-decoder state after the symbol and
    desyncs every later coefficient read on the noisy content.

The sweep tries remembered/nearby candidates first, then the full u15
space. The recovered value is pinned in av1_tables.npz (extract tool
regenerates it) and validated forever after by the LR conformance tests.

Usage: python tools/calibrate_lr_cdf.py
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("OAVIF_PY_TILE", "1")

from oavif_jax.av1 import frame as frame_mod
from oavif_jax.av1.frame import TileEncoder, _adaptive
from oavif_jax.av1.mux import mux_avif
from oavif_jax.av1.obu import FrameConfig, SequenceConfig, assemble_av1_stream
from oavif_jax.io.avif_ctypes import decode_to_yuv


def make_planes(n=32, seed=3):
    rng = np.random.default_rng(seed)
    return [
        np.asarray(128 + rng.integers(-60, 60, (n, n)), dtype=np.int32)
        for _ in range(3)
    ]


class _TraceShim:
    """Records the (cdf-row, symbol)/bool op stream of one tile encode so
    each candidate trial replays ONLY the arithmetic coding — the block
    search runs once, making a full 32k-probability sweep minutes."""

    def __init__(self):
        self.ops = []
        self._snaps = {}

    def _touch(self, row):
        base = row.base if row.base is not None else row
        if id(base) not in self._snaps:
            self._snaps[id(base)] = (base, base.copy())

    def sym_adapt(self, cdf_row, s):
        self._touch(cdf_row)
        self.ops.append(("a", cdf_row, s))

    def sym_noadapt(self, cdf_row, s):
        self._touch(cdf_row)
        self.ops.append(("n", cdf_row, s))

    def bool_q15(self, val, f):
        self.ops.append(("b", val, f))

    def write_literal(self, v, n):
        self.ops.append(("l", v, n))

    def done(self):
        return b""

    coeffs = None

    def reset_cdfs(self):
        for base, snap in self._snaps.values():
            base[...] = snap

    def replay(self) -> bytes:
        from oavif_jax.av1.entropy.rangecoder import RangeEncoder, update_cdf

        enc = RangeEncoder()
        for op, x, y in self.ops:
            if op == "a":
                nsym = len(x) - 1
                enc.encode_symbol(y, x, nsym)
                update_cdf(x, y, nsym)
            elif op == "n":
                enc.encode_symbol(y, x, len(x) - 1)
            elif op == "b":
                enc.encode_bool_q15(x, y)
            else:
                for i in range(y - 1, -1, -1):
                    enc.encode_bool_q15((x >> i) & 1, 16384)
        return enc.done()


def main():
    import time

    planes = make_planes()
    n = planes[0].shape[0]
    qindex = 60
    # no-LR sanity: the same stream without restoration must decode exact
    te = TileEncoder([p.copy() for p in planes], qindex, 8, 9)
    tile = te.encode()
    seq0 = SequenceConfig(width=n, height=n)
    fr0 = FrameConfig(width=n, height=n, base_q_idx=qindex)
    yuv, _, _ = decode_to_yuv(
        mux_avif(assemble_av1_stream(seq0, fr0, [tile]), n, n))
    assert all(np.array_equal(yuv[i], te.recon[i][:n, :n]) for i in range(3)), \
        "no-LR baseline stream does not decode exact; fix syntax first"
    print("no-LR baseline exact; tracing the LR tile encode...", flush=True)

    lr = {
        "types": (2, 0, 0),
        "unit_shift": 2,
        "wiener": {0: [[[0, 0, 0, 0, 0, 0]]]},  # identity taps, 1 RU
    }
    te = TileEncoder([p.copy() for p in planes], qindex, 8, 9, lr=lr)
    wrow = _adaptive(np.array([16384, 0], dtype=np.uint16))
    te.cdf.wiener_restore = wrow
    trace = _TraceShim()
    te.enc = trace
    te.encode()
    recon = [te.recon[i][:n, :n].copy() for i in range(3)]
    print(f"trace: {len(trace.ops)} ops; sweeping...", flush=True)

    seq = SequenceConfig(width=n, height=n, enable_restoration=True)
    fr = FrameConfig(
        width=n, height=n, base_q_idx=qindex,
        enable_restoration=True, lr_types=(2, 0, 0), lr_unit_shift=2,
    )

    def try_prob(p: int) -> bool:
        trace.reset_cdfs()
        wrow[0] = 32768 - p
        wrow[1] = 0
        wrow[2] = 0
        payload = trace.replay()
        data = mux_avif(assemble_av1_stream(seq, fr, [payload]), n, n)
        try:
            dec, _, _ = decode_to_yuv(data)
        except Exception:
            return False
        return all(np.array_equal(dec[i], recon[i]) for i in range(3))

    first = [11570, 4238, 16384, 20036, 24957, 26704, 27530, 29564, 29444,
             26872, 12732, 7811, 6064, 5238, 3204, 3324, 5896, 28530,
             16855, 9413, 22581, 21198, 30531]
    t0 = time.time()
    tried = set()
    for p in first + list(range(1, 32768)):
        if p in tried or not (0 < p < 32768):
            continue
        tried.add(p)
        if len(tried) % 2048 == 0:
            print(f"  ...{len(tried)} tried ({time.time()-t0:.0f}s)",
                  flush=True)
        if try_prob(p):
            print(f"FOUND wiener_restore prob = {p} (icdf {32768 - p})")
            return
    print("NOT FOUND — syntax bug upstream of the CDF (subexp/lr_params?)")


if __name__ == "__main__":
    main()

"""Batched encode planning (JAX) — the device side of the encoder.

The per-tile symbol coding is entropy-inherent serial (native C runtime),
but every SEARCH upstream of it is dense, batched math that belongs on the
device. One jitted call plans the whole frame:

  - all-blocks × all-modes intra prediction from source edges at the 64,
    32 and 16 grids (the standard source-edge approximation the host
    heuristics already use)
  - SSD mode scoring + argmin per block
  - the partition decisions (64 NONE vs SPLIT incl. the chroma flat
    gates, 32 NONE vs 4×16) with the same penalty formulas as the host

The host tile coder then executes the plan: per planned block it runs ONE
prediction + quantize + symbol emission instead of its own searches.
Reconstruction stays bit-exact (recon prediction uses decoded neighbors on
both sides of the boundary; the plan only pins DECISIONS, which any
conformant encoder is free to make).

The source planes are device-resident across TQ probes (they don't change
with the quantizer; only the dq-derived gates do), so a probe pays one
small device step + a tiny plan download.

Several devices: tiles are the AV1 parallel axis (SURVEY.md §2c). The
product places each tile's planner on its own device, round-robin
(frame._get_planner_locked); __graft_entry__.dryrun_multichip shard_maps
this planner over a tile mesh axis (tests/test_multidevice.py).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .tables import TABLES

# spec mode ids in search order: DC, V, H, SMOOTH, PAETH, SMOOTH_V,
# SMOOTH_H, then the 6 directional families (D45, D135, D113, D157, D203,
# D67). The first 5 are the "base" set used by the partition heuristics;
# the directional tail is the nomination set: the planner scores them on
# device alongside the others and the host encodes whichever
# wins, with the same 12.5% symbol-rate premium as the host search.
MODE_IDS = np.array([0, 1, 2, 9, 12, 10, 11, 3, 4, 5, 6, 7, 8],
                    dtype=np.int32)
N_MODES = 7
N_MODES_DIR = 13
N_BASE = 5
_DIR_ANGLES = (45, 135, 113, 157, 203, 67)  # matches MODE_IDS[7:]


def _sm_weights(n: int) -> jnp.ndarray:
    return jnp.asarray(TABLES[f"sm_weights_{n}"], dtype=jnp.float32)


def _predict_modes(above, left, corner, n_px: int, nmodes: int):
    """above/left: (n, n_px) float32; corner: (n,).

    Returns (n, nmodes, n_px, n_px) float32 predictions (integer-valued;
    decisions only — exact integer recon happens host-side)."""
    n = above.shape[0]
    a = above[:, None, :]
    l = left[:, :, None]
    c = corner[:, None, None]

    dc = (above.sum(-1) + left.sum(-1) + n_px) // (2 * n_px)
    dc = jnp.broadcast_to(dc[:, None, None], (n, n_px, n_px))
    v = jnp.broadcast_to(a, (n, n_px, n_px))
    h = jnp.broadcast_to(l, (n, n_px, n_px))

    w = _sm_weights(n_px)
    below = left[:, -1][:, None, None]
    right = above[:, -1][:, None, None]
    wr = w[None, :, None]
    wc = w[None, None, :]
    smooth = jnp.floor(
        (wr * a + (256.0 - wr) * below + wc * l + (256.0 - wc) * right + 256.0)
        / 512.0
    )

    base = a + l - c
    pa = jnp.abs(base - a)
    pl = jnp.abs(base - l)
    pc = jnp.abs(base - c)
    paeth = jnp.where(
        (pa <= pl) & (pa <= pc),
        jnp.broadcast_to(a, base.shape),
        jnp.where(pl <= pc, jnp.broadcast_to(l, base.shape),
                  jnp.broadcast_to(c, base.shape)),
    )
    preds = [dc, v, h, smooth, paeth]
    if nmodes >= 7:
        smooth_v = jnp.floor((wr * a + (256.0 - wr) * below + 128.0) / 256.0)
        smooth_h = jnp.floor((wc * l + (256.0 - wc) * right + 128.0) / 256.0)
        preds += [smooth_v, smooth_h]
    out = jnp.stack(preds, axis=1)
    if nmodes >= 13:
        out = jnp.concatenate(
            [out, _predict_directional_modes(above, left, corner, n_px)], 1
        )
    return out


def _predict_directional_modes(above, left, corner, n_px: int):
    """Directional prediction (spec 7.11.2.4, zero angle delta) for the 6
    non-cardinal families, vectorized over blocks. Every index and shift
    is static, so each output is a fixed two-tap combination of the edge
    vector: one static gather per tap. Taps and weights are small
    integers, so the float32 arithmetic is exact. (A dense matmul against
    the equivalent (2(2P+1), 6P²) weight matrix gives the same bits; on
    the H100 the gather is faster, tools/time_formulations.py.) Edges
    beyond n_px are last-sample replicated (nomination-grade; the host
    builds exact edges when it encodes the chosen mode)."""
    n = above.shape[0]
    P = n_px
    aE = jnp.concatenate(
        [above, jnp.broadcast_to(above[:, -1:], (n, P))], 1)
    lE = jnp.concatenate(
        [left, jnp.broadcast_to(left[:, -1:], (n, P))], 1)
    # the -1-indexed above edge, then the -1-indexed left edge
    E = jnp.concatenate([corner[:, None], aE, corner[:, None], lE], 1)
    i0, w0, i1, w1 = _dir_taps(P)
    v = jnp.floor((E[:, i0] * w0 + E[:, i1] * w1 + 16.0) / 32.0)
    return v.reshape(n, len(_DIR_ANGLES), P, P)


@functools.lru_cache(maxsize=None)
def _dir_taps(n_px: int):
    """Static taps realizing the spec zone formulas: for each of the
    6*P*P outputs (mode-major, then row, then column), indices i0, i1
    into the edge vector of _predict_directional_modes and weights
    32 - shift and shift. Returned as numpy (int32, float32, int32,
    float32) arrays."""
    from .tables import TABLES as _T

    P = n_px
    dr = np.asarray(_T["dr_intra_derivative"], dtype=np.int64)
    L = 2 * P + 1  # length of one -1-indexed edge
    mx = 2 * P - 1  # last sample of the replicated edge
    r = np.arange(P)[:, None]
    c = np.arange(P)[None, :]
    shape = (len(_DIR_ANGLES), P, P)
    i0 = np.zeros(shape, np.int32)
    i1 = np.zeros(shape, np.int32)
    sh = np.zeros(shape, np.int64)
    for mi, angle in enumerate(_DIR_ANGLES):
        if angle < 90:  # zone 1: above edge only
            x = (r + 1) * int(dr[angle])
            base = (x >> 6) + c
            i0[mi] = 1 + np.minimum(base, mx)
            i1[mi] = 1 + np.minimum(base + 1, mx)
            sh[mi] = (x >> 1) & 0x1F
        elif angle > 180:  # zone 3: left edge only
            y = (c + 1) * int(dr[270 - angle])
            base = (y >> 6) + r
            i0[mi] = L + 1 + np.minimum(base, mx)
            i1[mi] = L + 1 + np.minimum(base + 1, mx)
            sh[mi] = (y >> 1) & 0x1F
        else:  # zone 2: above where it reaches, else left
            x = (c << 6) - (r + 1) * int(dr[180 - angle])
            y = (r << 6) - (c + 1) * int(dr[angle - 90])
            bx, by = x >> 6, y >> 6
            use_above = bx >= -1
            i0[mi] = np.where(use_above, np.clip(bx + 1, 0, 2 * P),
                              L + np.clip(by + 1, 0, 2 * P))
            i1[mi] = np.where(use_above, np.clip(bx + 2, 0, 2 * P),
                              L + np.clip(by + 2, 0, 2 * P))
            sh[mi] = np.where(use_above, (x >> 1) & 0x1F, (y >> 1) & 0x1F)
    w1 = sh.reshape(-1).astype(np.float32)
    return i0.reshape(-1), 32.0 - w1, i1.reshape(-1), w1


def _grid_edges(p, nby, nbx, n_px, base):
    """Blocks + source edges at an n_px grid from the (+1,+1)-padded
    plane, with the decoder's unavailability fills (spec 7.11.2)."""
    H, W = nby * n_px, nbx * n_px
    blocks = (
        p[1 : 1 + H, 1 : 1 + W]
        .reshape(nby, n_px, nbx, n_px)
        .transpose(0, 2, 1, 3)
        .reshape(nby * nbx, n_px, n_px)
    )
    above = p[0:H:n_px, 1 : 1 + W].reshape(nby, nbx, n_px)
    left = (
        p[1 : 1 + H, 0:W:n_px].reshape(nby, n_px, nbx).transpose(0, 2, 1)
    )
    corner = p[0:H:n_px, 0:W:n_px]

    bi = jnp.arange(nby)[:, None, None]
    bj = jnp.arange(nbx)[None, :, None]
    # above row missing (i==0): left present (j>0) → left[0], else 127
    above = jnp.where(
        bi == 0,
        jnp.where(bj > 0, left[..., :1], jnp.float32(base - 1)),
        above,
    )
    # left col missing (j==0): above present (i>0) → above[0], else 129
    left = jnp.where(
        bj == 0,
        jnp.where(bi > 0, above[..., :1], jnp.float32(base + 1)),
        left,
    )
    ci = jnp.arange(nby)[:, None]
    cj = jnp.arange(nbx)[None, :]
    corner = jnp.where(
        (ci == 0) & (cj == 0),
        jnp.float32(base),
        jnp.where(
            ci == 0, left[..., 0], jnp.where(cj == 0, above[..., 0], corner)
        ),
    )
    n = nby * nbx
    return (
        blocks,
        above.reshape(n, n_px),
        left.reshape(n, n_px),
        corner.reshape(n),
    )


def _exact_ssd(err):
    """Sum of squares over the last two axes of an integer-valued float32
    error, exact in uint32: |err| <= 1023 at 10 bits, so even a 64x64 sum
    stays below 2^32. Integer sums do not depend on the order of the
    reduction, so every backend gets the same value (float32 sums pass
    2^24 and round differently on the GPU and the CPU)."""
    e = err.astype(jnp.int32)
    return jnp.sum((e * e).astype(jnp.uint32), axis=(-2, -1),
                   dtype=jnp.uint32)


def _mode_ssd(p, nby, nbx, n_px, base, nmodes):
    """(exact ssd (n, nmodes) uint32, premium-weighted ssd (n, nmodes)
    float32) for every n_px block."""
    blocks, above, left, corner = _grid_edges(p, nby, nbx, n_px, base)
    preds = _predict_modes(above, left, corner, n_px, nmodes)
    exact = _exact_ssd(preds - blocks[:, None])
    ssd = exact.astype(jnp.float32)
    if nmodes > 7:
        # directional modes carry a symbol-rate premium (rarer kf_y
        # symbols + angle_delta) plus the planner's replicated-edge
        # optimism for the zone-1/3 families — stiffer than the host
        # search's 12.5% (calibrated on the edges/photo probes)
        ssd = ssd.at[:, 7:].multiply(1.4)
    return exact, ssd


def _plan_device_body(y, u, v, dq_ac, qindex_f, nby: int, nbx: int,
                      bitdepth: int, nmodes: int = N_MODES_DIR,
                      duel_level: int = 0):
    """Device planning step. y/u/v: (sby*64+1, sbx*64+1) padded planes
    (+1 border row/col). Returns (plan64 (sby,sbx), mode32 (nby,nbx),
    part32_split (nby,nbx), mode16 (2nby, 2nbx))."""
    # planes arrive as int16 (pixel values fit 12 bits): half the
    # host->device bytes of float32; the cast fuses into the first op
    y = y.astype(jnp.float32)
    u = u.astype(jnp.float32)
    v = v.astype(jnp.float32)
    base = jnp.float32(1 << (bitdepth - 1))
    sby, sbx = nby // 2, nbx // 2

    # 64-blocks keep the 7-mode set (NONE-at-64 is gated to flat SBs
    # where directional modes can't win); 32 stays at 7 too (tx32 has no
    # ADST, so directional residuals code badly there — measured +5-7%
    # bytes); only the 16 grid takes the directional nomination set,
    # where the tx-16 ADST two-way makes the residuals pay
    ex64, ssd64 = _mode_ssd(y, sby, sbx, 64, base, N_MODES)
    ex32, ssd32 = _mode_ssd(y, nby, nbx, 32, base, N_MODES)
    ex16, ssd16 = _mode_ssd(y, nby * 2, nbx * 2, 16, base, nmodes)

    # base-mode minima and their 2x2 child sums stay exact in uint32 (a
    # sum of four 32-grid SSDs is bounded like one 64-grid SSD)
    best64_base = jnp.min(ex64[:, :N_BASE], axis=1)
    best32_base = jnp.min(ex32[:, :N_BASE], axis=1)
    best16_base = jnp.min(ex16[:, :N_BASE], axis=1)

    mode32 = jnp.argmin(ssd32, axis=1)
    mode64 = jnp.argmin(ssd64, axis=1)
    # 16 grid: non-directional winner always; when a directional mode
    # beats it on premium-adjusted SSD, pack it as a NOMINEE in the high
    # byte — the host runs a real D+lambda*R trial between the two
    # (SSD alone measured byte-negative; rate-aware selection is what
    # makes directional pay at the default speed)
    mode16_nd = jnp.argmin(ssd16[:, :N_MODES], axis=1)
    if duel_level >= 1:
        # runner-up duel at the 16 grid (any mode kind)
        best16 = jnp.argmin(ssd16, axis=1)
        ssd16_x = ssd16.at[jnp.arange(ssd16.shape[0]), best16].set(jnp.inf)
        run16 = jnp.argmin(ssd16_x, axis=1)
        mode16 = best16 + ((run16 + 1) << 8)
    elif nmodes > N_MODES:
        dir_idx = jnp.argmin(ssd16[:, N_MODES:], axis=1) + N_MODES
        dir_wins = (
            jnp.take_along_axis(ssd16, dir_idx[:, None], 1)[:, 0]
            < jnp.take_along_axis(ssd16, mode16_nd[:, None], 1)[:, 0]
        )
        mode16 = mode16_nd + jnp.where(dir_wins, (dir_idx + 1) << 8, 0)
    else:
        mode16 = mode16_nd

    # --- partition 64: NONE only on flat SBs (mirrors the host
    # _choose_partition64: parent-vs-kids + luma and chroma flat gates) ---
    k32 = best32_base.reshape(nby // 2, 2, nbx // 2, 2).sum(
        axis=(1, 3), dtype=jnp.uint32)
    k32 = k32.reshape(-1).astype(jnp.float32)
    best64_base = best64_base.astype(jnp.float32)
    penalty64 = 4.0 * dq_ac * dq_ac
    flat_gate = jnp.float32(64 * 64) * dq_ac * dq_ac / 64.0

    def dc_ssd64(pl):
        blocks, above, left, corner = _grid_edges(pl, sby, sbx, 64, base)
        preds = _predict_modes(above, left, corner, 64, 1)  # DC only
        return _exact_ssd(preds[:, 0] - blocks).astype(jnp.float32)

    uv_flat = (dc_ssd64(u) <= flat_gate) & (dc_ssd64(v) <= flat_gate)
    none64 = (
        (best64_base <= k32 + penalty64)
        & (best64_base <= flat_gate)
        & uv_flat
    )
    plan64 = jnp.where(none64, mode64 + 1, 0).astype(jnp.int32)

    # --- partition 32: NONE vs SPLIT (mirrors _choose_partition32 incl.
    # the speed/q gate, applied host-side) ---
    k16 = best16_base.reshape(nby, 2, nbx, 2).sum(
        axis=(1, 3), dtype=jnp.uint32).reshape(-1).astype(jnp.float32)
    penalty32 = dq_ac * dq_ac
    split32 = (k16 + penalty32) < best32_base.astype(jnp.float32)
    gate_on = qindex_f <= 90.0
    split32 = split32 & gate_on

    # ONE packed int32 vector → one device→host fetch instead of four.
    # Layout matches the C runtime's plan buffer.
    return jnp.concatenate(
        [
            plan64.reshape(-1),
            mode32.astype(jnp.int32),
            split32.astype(jnp.int32),
            mode16.astype(jnp.int32),
        ]
    )


_plan_device = jax.jit(
    _plan_device_body,
    static_argnames=("nby", "nbx", "bitdepth", "nmodes", "duel_level"),
)


class Plan(dict):
    """Plan dict that supports weak references (the cross-probe decision
    cache in frame.py keys decision buffers by live plan instances)."""

    __slots__ = ("__weakref__",)


def unpack_plan(packed: np.ndarray, nby: int, nbx: int) -> Dict[str, np.ndarray]:
    """Packed device plan vector → the host plan dict (spec mode ids)."""
    sby, sbx = nby // 2, nbx // 2
    n64, n32 = sby * sbx, nby * nbx
    packed = np.asarray(packed)
    ids = MODE_IDS
    p64 = packed[:n64].reshape(sby, sbx)
    m32 = packed[n64 : n64 + n32].reshape(nby, nbx)
    s32 = packed[n64 + n32 : n64 + 2 * n32].reshape(nby, nbx)
    m16 = packed[n64 + 2 * n32 :].reshape(nby * 2, nbx * 2)
    plan64 = np.where(p64 > 0, ids[np.maximum(p64 - 1, 0)] + 1, 0)
    # mode16 may carry a directional nominee index in the high byte;
    # map both fields to spec mode ids (nominee kept as (id+1)<<8)
    m16_low = ids[m16 & 0xFF].astype(np.int32)
    m16_high = (m16 >> 8).astype(np.int64)
    nominee = np.where(m16_high > 0, ids[np.maximum(m16_high - 1, 0)] + 1, 0)
    return Plan(
        plan64=plan64.astype(np.int32),
        mode32=ids[m32].astype(np.int32),
        part32=s32.astype(np.int32),
        mode16=(m16_low + (nominee.astype(np.int32) << 8)).astype(np.int32),
    )


class FramePlanner:
    """Caches the device-resident padded planes of one image and plans
    per probe (the planes don't change with the quantizer)."""

    def __init__(self, planes, bitdepth: int = 8,
                 nmodes: int = N_MODES_DIR, duel_level: int = 0,
                 device=None):
        self.nmodes = nmodes
        self.duel_level = duel_level
        self.device = device
        # the corpus pipeline prefetches plans from a worker thread while
        # the encode path plans inline; serializing per planner keeps the
        # returned Plan INSTANCE stable per (qindex window), which the
        # decision-reuse cache's id(plan) binding depends on
        import threading

        self._plan_lock = threading.RLock()
        y = np.asarray(planes[0])
        h, w = y.shape
        self.h, self.w = h, w
        self.bitdepth = bitdepth
        self.sby, self.sbx = h // 64, w // 64
        self.nby, self.nbx = self.sby * 2, self.sbx * 2
        if self.sby == 0 or self.sbx == 0:
            self.dev = None
            return
        # SHAPE BUCKETING: pad the SB grid up to a multiple of 4 (256 px)
        # so corpora with many distinct image sizes share compiled planner
        # executables (each new shape is a fresh compile).
        # Cropped plans are identical to unpadded ones: prediction edges
        # are LEFT/TOP only, so real blocks never see the right/bottom
        # padding (tests/test_multidevice.py pins the equality).
        self.psby = -(-self.sby // 4) * 4
        self.psbx = -(-self.sbx // 4) * 4
        base = 1 << (bitdepth - 1)
        H, W = self.sby * 64, self.sbx * 64
        PH, PW = self.psby * 64, self.psbx * 64
        devp = []
        for pi in range(3):
            pl = np.asarray(planes[pi]) if len(planes) > 1 else y
            # int16 transfer (values <= 12-bit); _plan_device_body casts
            # to float32 on device
            p = np.empty((PH + 1, PW + 1), dtype=np.int16)
            p[1 : 1 + H, 1 : 1 + W] = pl[:H, :W]
            # edge-replicate into the bucket padding (content there only
            # shapes padded-SB plans, which are cropped away)
            p[1 : 1 + H, 1 + W :] = p[1 : 1 + H, W : W + 1]
            p[1 + H :, 1:] = p[H : H + 1, 1:]
            p[0, :] = base - 1
            p[:, 0] = base + 1
            p[0, 0] = base
            devp.append(jax.device_put(p, self.device) if self.device
                        is not None else jnp.asarray(p))
        self.dev = devp
        self._plan_cache: Dict[int, dict] = {}

    def plan(self, qindex: int) -> Optional[dict]:
        """Returns {"plan64","mode32","part32","mode16"} numpy arrays
        (spec mode ids), or None when the frame has no full SBs."""
        if self.dev is None:
            return None
        with self._plan_lock:
            return self._plan_locked(qindex)

    def _plan_locked(self, qindex: int) -> Optional[dict]:
        # plans vary with q only through dq-scaled gates; probes at nearby
        # quantizers reuse the cached plan (never across the qindex-90
        # partition gate) — saves a device step + fetch per probe
        for qk, cached in self._plan_cache.items():
            if abs(qk - qindex) <= 16 and (qk <= 90) == (qindex <= 90):
                return cached
        from .tables import ac_q

        pnby, pnbx = self.psby * 2, self.psbx * 2
        packed = np.asarray(
            _plan_device(
                self.dev[0], self.dev[1], self.dev[2],
                jnp.float32(ac_q(qindex, self.bitdepth)),
                jnp.float32(qindex),
                pnby, pnbx, self.bitdepth, self.nmodes,
                self.duel_level,
            )
        )
        plan = unpack_plan(packed, pnby, pnbx)
        if (pnby, pnbx) != (self.nby, self.nbx):
            plan = Plan(
                plan64=plan["plan64"][: self.sby, : self.sbx],
                mode32=plan["mode32"][: self.nby, : self.nbx],
                part32=plan["part32"][: self.nby, : self.nbx],
                mode16=plan["mode16"][: 2 * self.nby, : 2 * self.nbx],
            )
        if len(self._plan_cache) >= 8:
            self._plan_cache.clear()
        self._plan_cache[qindex] = plan
        return plan


def plan_frame(y_plane: np.ndarray, qindex: int, bitdepth: int = 8):
    """Back-compat single-plane entry (Y only): plans with U=V=Y flat
    gates disabled by passing Y for chroma. Prefer FramePlanner."""
    fp = FramePlanner([y_plane, y_plane, y_plane], bitdepth)
    return fp.plan(qindex)

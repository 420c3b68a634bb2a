"""Device-resident per-probe level computation (the batched encode stage).

The device's answer to the reference encoder's per-probe transform/quant
work (the whole libaom encode runs inside avifEncoderAddImage, reference
src/io.zig:629-632): given the device plan's per-block modes, ONE jitted
call computes, for every 16x16 luma block of the frame and for a BATCH of
candidate quantizers, the open-loop forward transform + quantized levels —
the math the serial host coder would otherwise redo per probe. The host
then keeps only the entropy-inherent work: symbol emission and exact recon
(dequant + normative integer inverse of the received levels — bit-exactness
of the shipped stream does not depend on how the levels were chosen).

Open-loop: residuals here are taken against SOURCE-edge predictions
(the planner's edges), while the decoder predicts from recon edges. The
coded stream stays conformant (levels are encoder freedom) at a small
quality cost where recon has drifted from source; the host consumer
guards each block with a prediction-delta check and falls back to its
exact closed-loop path when the drift is visible (device_levels_guard).

Off by default (OAVIF_DEVICE_LEVELS=1 turns it on): only the Python tile
coder consumes the levels, and the C coder does not yet.

The quantizer-batch axis is what re-arms batched speculative TQ passes
(BASELINE config 2): one device step serves a whole speculative round.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .device_plan import _grid_edges, _predict_modes
from .tables import TABLES


@functools.lru_cache(maxsize=None)
def _fwd_mats16():
    # cached as NUMPY (a cached jnp constant created under one trace
    # leaks into later traces)
    from .transform import fwd_matrices

    fh, fw = fwd_matrices(16, 16, "dct_dct")
    return (np.asarray(fh, np.float32), np.asarray(fw, np.float32))


@functools.lru_cache(maxsize=None)
def _scan16():
    """Natural -> scan order as a static index (cached as numpy — see
    _fwd_mats16)."""
    return np.asarray(TABLES["scan_16x16"], np.int32)


def _coeffs_body(p, nby, nbx, modes16, bitdepth: int):
    """Per-source+plan stage: forward coefficients of every 16-block's
    open-loop residual under its PLANNED mode. Returns (n, 16, 16) f32."""
    p = p.astype(jnp.float32)  # planner planes are int16 on device
    base = jnp.float32(1 << (bitdepth - 1))
    blocks, above, left, corner = _grid_edges(p, nby, nbx, 16, base)
    preds = _predict_modes(above, left, corner, 16, 7)  # (n, 7, 16, 16)
    onehot = jax.nn.one_hot(modes16.reshape(-1), 7, dtype=jnp.float32)
    # HIGHEST: float32 products on the GPU otherwise run in TF32, whose
    # ~3 decimal digits would move levels across rounding boundaries
    hi = jax.lax.Precision.HIGHEST
    pred = jnp.einsum("nmhw,nm->nhw", preds, onehot, precision=hi)
    resid = blocks - pred
    fh, fw = _fwd_mats16()
    c = jnp.einsum("ij,njk->nik", fh, resid, precision=hi)
    return jnp.einsum("nik,lk->nil", c, fw, precision=hi)


def _quant_body(coeffs, dq_dc, dq_ac, shift: int):
    """Per-probe stage: round-half quantization of cached coefficients
    at one quantizer. dq_*: f32 scalars. Returns (n, 256) int16 levels
    (natural order) and (n,) int32 eob."""
    n = coeffs.shape[0]
    cf = coeffs.reshape(n, 256)
    dq = jnp.full((256,), dq_ac, jnp.float32).at[0].set(dq_dc)
    up = jnp.float32(1 << shift)
    mag = jnp.floor(jnp.abs(cf) * up / dq[None, :] + 0.5)
    lv = jnp.where(cf < 0, -mag, mag)
    lv = jnp.clip(lv, -16383, 16383)
    # eob: last nonzero position in scan order
    sc_nz = (lv[:, _scan16()] != 0).astype(jnp.int32)
    idx = jnp.arange(1, 257, dtype=jnp.int32)[None, :]
    eob = jnp.max(sc_nz * idx, axis=1)
    return lv.astype(jnp.int16), eob


_coeffs_jit = jax.jit(_coeffs_body, static_argnames=("nby", "nbx", "bitdepth"))
_quant_batch = jax.jit(
    jax.vmap(_quant_body, in_axes=(None, 0, 0, None)),
    static_argnames=("shift",),
)


class DeviceLevels:
    """Holds the per-(source, plan) coefficient cache on device and
    serves per-probe (or probe-batch) level computation."""

    def __init__(self, planner, bitdepth: int = 8):
        self.planner = planner
        self.bitdepth = bitdepth
        self._coeff_key = None
        self._coeffs = None

    def _ensure_coeffs(self, modes16: np.ndarray):
        key = modes16.tobytes()
        if self._coeff_key == key:
            return
        pl = self.planner
        pnby, pnbx = pl.psby * 2, pl.psbx * 2
        self._coeffs = _coeffs_jit(
            pl.dev[0], pnby * 2, pnbx * 2,
            jnp.asarray(modes16, jnp.int32), self.bitdepth,
        )
        self._coeff_key = key

    def levels(self, modes16: np.ndarray, qindexes) -> tuple:
        """modes16: (2*pnby, 2*pnbx) planner-order mode INDICES (0..6);
        qindexes: iterable of qindex ints. Returns (levels (k, n, 256)
        int16 natural order, eob (k, n) int32) as numpy — ONE fetch."""
        from .tables import ac_q, dc_q

        self._ensure_coeffs(np.asarray(modes16, np.int32))
        qs = list(qindexes)
        dqd = jnp.asarray([float(dc_q(q, self.bitdepth)) for q in qs],
                          jnp.float32)
        dqa = jnp.asarray([float(ac_q(q, self.bitdepth)) for q in qs],
                          jnp.float32)
        lv, eob = _quant_batch(self._coeffs, dqd, dqa, 0)
        return np.asarray(lv), np.asarray(eob)


def device_levels_enabled() -> bool:
    """OAVIF_DEVICE_LEVELS=1 turns the stage on (default off: the
    byte-identical C<->Python invariant holds only when both coders make
    the same level choices, and the C runtime does not consume device
    levels yet)."""
    return os.environ.get("OAVIF_DEVICE_LEVELS", "0") == "1"

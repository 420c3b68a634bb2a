"""Width-sharded Wiener loop restoration over a device mesh.

The encode-side collective for the multi-device dry run
(SURVEY.md §2c: "boundary pixels ... via collectives"): each device
filters its width slice of the frame, and the 7-tap horizontal pass's
cross-shard support (3 columns each side) moves over the mesh axis with
`lax.ppermute` — an algorithmic halo exchange, not a checksum. Rows are
not sharded, so the stripe sandwich (out-of-stripe rows reading the
pre-CDEF deblocked frame) stays local.

All arithmetic is int32, identical op-for-op to the host reference
(oavif_jax.av1.restoration.wiener_unit): the sharded output equals the
host filter EXACTLY (asserted in the dry run and
tests/test_multidevice.py). The dry-run simplification: one tap set for
the whole frame (per plane) rather than a per-unit grid — the halo and
stripe machinery are the parts the mesh touches.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .restoration import FILTER_BITS, _band_rows


def _coeffs7_np(t0, t1, t2):
    c = 128 - 2 * (t0 + t1 + t2)
    return np.array([t0, t1, t2, c, t2, t1, t0], dtype=np.int32)


def apply_wiener_sharded(cdef_planes: List[np.ndarray],
                         deblk_planes: List[np.ndarray],
                         vis_h: int, vis_w: int,
                         taps_per_plane: dict, bitdepth: int,
                         mesh, axis: str = "tile") -> List[np.ndarray]:
    """Filter every plane with its 6-tap Wiener set, width-sharded over
    `mesh[axis]`. taps_per_plane[p] = (v0,v1,v2,h0,h1,h2) or None.
    Returns host arrays equal to the unsharded filter bit-for-bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[axis]
    assert vis_w % n_shards == 0, "dry-run frames shard evenly"
    round0, round1 = 3, 11
    offset = 1 << (bitdepth + FILTER_BITS - round0 - 1)
    limit = (1 << (bitdepth + 1 + FILTER_BITS - round0)) - 1
    hi = (1 << bitdepth) - 1

    def filter_plane(cdef, deblk, vf, hf):
        """One width shard: (H, W/n) slices; vf/hf are (7,) int32."""
        idx = jax.lax.axis_index(axis)
        out_bands = []
        for r0, r1, ss, se in _band_rows(0, vis_h):
            h = r1 - r0
            rows = np.clip(np.arange(r0 - 3, r1 + 3), 0, vis_h - 1)
            above = rows < ss
            below = rows > se
            rsel = np.where(above, np.maximum(ss - 2, rows),
                            np.where(below, np.minimum(se + 2, rows), rows))
            use_deblk = (above | below)[:, None]
            src = jnp.where(use_deblk, deblk[rsel], cdef[rsel])
            # --- halo exchange: 3 columns each side over the mesh axis.
            # Interior boundaries take the neighbor's edge columns;
            # frame edges replicate the local edge column (the spec's
            # x clamp to [0, vis_w-1]).
            right_edge = src[:, -3:]
            left_edge = src[:, :3]
            fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            from_left = jax.lax.ppermute(right_edge, axis, fwd)
            from_right = jax.lax.ppermute(left_edge, axis, bwd)
            rep_l = jnp.repeat(src[:, :1], 3, axis=1)
            rep_r = jnp.repeat(src[:, -1:], 3, axis=1)
            halo_l = jnp.where(idx == 0, rep_l, from_left)
            halo_r = jnp.where(idx == n_shards - 1, rep_r, from_right)
            ext = jnp.concatenate([halo_l, src, halo_r], axis=1)
            w = src.shape[1]
            # horizontal pass -> clamped intermediate (h+6, w)
            s = jnp.zeros((h + 6, w), jnp.int32)
            for t in range(7):
                s = s + hf[t] * ext[:, t : t + w]
            inter = jnp.clip((s + (1 << (round0 - 1))) >> round0,
                             -offset, limit - offset)
            # vertical pass (rows local)
            s2 = jnp.zeros((h, w), jnp.int32)
            for t in range(7):
                s2 = s2 + vf[t] * inter[t : t + h]
            v = (s2 + (1 << (round1 - 1))) >> round1
            out_bands.append(jnp.clip(v, 0, hi))
        return jnp.concatenate(out_bands, axis=0)

    spec_in = P(None, axis)
    sharded = jax.shard_map(
        filter_plane, mesh=mesh,
        in_specs=(spec_in, spec_in, P(), P()),
        out_specs=spec_in, check_vma=False,
    )
    jitted = jax.jit(
        sharded,
        in_shardings=(
            NamedSharding(mesh, spec_in), NamedSharding(mesh, spec_in),
            NamedSharding(mesh, P()), NamedSharding(mesh, P()),
        ),
        out_shardings=NamedSharding(mesh, spec_in),
    )

    out = []
    for p, cdef in enumerate(cdef_planes):
        taps = taps_per_plane.get(p)
        if taps is None:
            out.append(np.asarray(cdef[:vis_h, :vis_w]).copy())
            continue
        import jax.numpy as jnp  # noqa: F811

        vf = jnp.asarray(_coeffs7_np(*taps[0:3]))
        hf = jnp.asarray(_coeffs7_np(*taps[3:6]))
        cd = jnp.asarray(
            np.ascontiguousarray(cdef[:vis_h, :vis_w], dtype=np.int32))
        db = jnp.asarray(
            np.ascontiguousarray(deblk_planes[p][:vis_h, :vis_w],
                                 dtype=np.int32))
        out.append(np.asarray(jitted(cd, db, vf, hf)))
    return out

"""Tile-sharded SSIMULACRA2: the multi-chip scoring leg (SURVEY.md §2c).

The frame is width-sharded over the mesh's tile axis (matching the AV1
tile sharding of the encode). Per scale, each shard computes its slice of
the pyramid locally; the Gaussian's horizontal pass needs RADIUS columns
of each neighbor, exchanged with `ppermute` (the halo — frame borders
keep the zero padding of the single-device path), and the three feature
norms are global means reduced with `psum`. Every shard therefore returns
the same frame score.

Width slices must be even (the 2×2 pyramid downsample never straddles a
shard boundary then). Once a scale's slice narrows below the halo
radius the planes are `all_gather`ed and the remaining (tiny) scales
compute replicated — the same shard-while-big / gather-when-small
pattern the production pipeline uses.

This is the collective pattern the production multi-chip path uses:
spatial shard + halo for windowed ops + psum for frame-global
reductions. tests/test_multidevice.py asserts the sharded score matches
the single-device scorer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ssimulacra2 import (
    NUM_SCALES,
    WEIGHTS,
    _KERNEL_RADIUS,
    _finalize_score,
    _gauss_kernel,
    _num_scales,
    edge_diff_maps,
    linear_rgb_to_xyb_positive,
    rgb8_to_linear,
    ssim_error_map,
)

R = _KERNEL_RADIUS


def _halo_exchange(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """x (C, H, Wl) → (C, H, Wl + 2R) with R columns from each neighbor
    shard via ppermute; frame borders get the zero padding the
    single-device blur uses."""
    n = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    # my right edge becomes my right-neighbor's left halo, and vice versa
    right_edge = x[..., -R:]
    left_edge = x[..., :R]
    from_left = jax.lax.ppermute(
        right_edge, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    from_right = jax.lax.ppermute(
        left_edge, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    zero = jnp.zeros_like(from_left)
    from_left = jnp.where(idx == 0, zero, from_left)
    from_right = jnp.where(idx == n - 1, zero, from_right)
    return jnp.concatenate([from_left, x, from_right], axis=-1)


def _blur_sharded(img: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Separable σ=1.5 Gaussian on a width shard: horizontal VALID conv
    over the halo-extended slice, vertical with local zero padding —
    identical values to the single-device blur."""
    k = jnp.asarray(_gauss_kernel())
    ext = _halo_exchange(img, axis_name)
    x = ext[:, None]
    kh = k.reshape(1, 1, 1, -1)
    x = jax.lax.conv_general_dilated(
        x, kh, window_strides=(1, 1), padding=((0, 0), (0, 0)),
        precision=jax.lax.Precision.HIGHEST,
    )
    kv = k.reshape(1, 1, -1, 1)
    x = jax.lax.conv_general_dilated(
        x, kv, window_strides=(1, 1), padding=((R, R), (0, 0)),
        precision=jax.lax.Precision.HIGHEST,
    )
    return x[:, 0]


def _down2_local(img: jnp.ndarray) -> jnp.ndarray:
    """2×2 box downsample of a width shard (edge replication on odd H;
    shard widths are even by contract)."""
    c, h, w = img.shape
    ph = (-h) % 2
    x = jnp.pad(img, ((0, 0), (0, ph), (0, 0)), mode="edge")
    x = x.reshape(c, (h + ph) // 2, 2, w // 2, 2)
    return x.mean(axis=(2, 4))


def ssimulacra2_sharded_body(ref_slice, dist_slice, h: int, w: int,
                             axis_name: str):
    """Per-shard body (run under shard_map): ref/dist (Hs, Ws, 3) uint8
    width slices of the full (h, w) frame. Returns the replicated frame
    score."""
    from .ssimulacra2 import _blur_fir

    lin1 = rgb8_to_linear(ref_slice)
    lin2 = rgb8_to_linear(dist_slice)
    feats = []
    sharded = True
    for s in range(_num_scales(h, w)):
        if s:
            lin1 = _down2_local(lin1)
            lin2 = _down2_local(lin2)
        if sharded and lin1.shape[2] < 2 * R:
            # slice narrower than the halo: gather once, finish the tiny
            # coarse scales replicated
            lin1 = jax.lax.all_gather(lin1, axis_name, axis=2, tiled=True)
            lin2 = jax.lax.all_gather(lin2, axis_name, axis=2, tiled=True)
            sharded = False
        img1 = linear_rgb_to_xyb_positive(lin1)
        img2 = linear_rgb_to_xyb_positive(lin2)
        blur_ = (
            (lambda t: _blur_sharded(t, axis_name))
            if sharded
            else (lambda t: _blur_fir(t, R))
        )
        mu1 = blur_(img1)
        mu2 = blur_(img2)
        s11 = blur_(img1 * img1)
        s22 = blur_(img2 * img2)
        s12 = blur_(img1 * img2)

        d = ssim_error_map(mu1, mu2, s11, s22, s12)
        artifact, detail = edge_diff_maps(img1, mu1, img2, mu2)

        # frame-global means: psum of per-shard sums over the tile axis
        # (plain means once the coarse scales compute replicated)
        if sharded:
            npx_local = jnp.float32(d.shape[1] * d.shape[2])
            npx = jax.lax.psum(npx_local, axis_name)

            def gmean(m):
                return jax.lax.psum(m.sum(axis=(1, 2)), axis_name) / npx
        else:
            def gmean(m):
                return m.mean(axis=(1, 2))

        ssim1 = gmean(d)
        ssim4 = jnp.sqrt(jnp.sqrt(gmean(d ** 4)))
        a1 = gmean(artifact)
        a4 = jnp.sqrt(jnp.sqrt(gmean(artifact ** 4)))
        l1 = gmean(detail)
        l4 = jnp.sqrt(jnp.sqrt(gmean(detail ** 4)))
        feats.append(jnp.stack([ssim1, a1, l1, ssim4, a4, l4], axis=-1))

    nsc = len(feats)
    f = jnp.abs(jnp.stack(feats).transpose(1, 0, 2).reshape(-1))
    wmat = jnp.asarray(
        WEIGHTS.reshape(3, NUM_SCALES, 6)[:, :nsc, :].reshape(-1),
        dtype=jnp.float32,
    )
    return _finalize_score(jnp.sum(f * wmat))


def compute_ssimulacra2_sharded(ref_rgb8, dist_rgb8, mesh, axis: str = "tile"):
    """Score two (H, W, 3) uint8 frames with the width sharded over the
    given mesh axis. Returns a float (identical on every shard)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    h, w = ref_rgb8.shape[:2]
    n = mesh.shape[axis]
    assert w % n == 0 and (w // n) % 2 == 0, (w, n)

    body = functools.partial(
        ssimulacra2_sharded_body, h=h, w=w, axis_name=axis
    )
    specs = P(None, axis, None)
    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(specs, specs), out_specs=P(),
        check_vma=False,
    )
    ref = jnp.asarray(np.ascontiguousarray(ref_rgb8), dtype=jnp.uint8)
    dist = jnp.asarray(np.ascontiguousarray(dist_rgb8), dtype=jnp.uint8)
    return float(jax.jit(fn)(ref, dist))

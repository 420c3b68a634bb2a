"""Multi-device tile encode: the PRODUCT planner sharded over a tile mesh
axis must produce exactly the single-device plans and drive the product
tile coders to identical bitstreams (SURVEY.md §2c tile→chip mapping;
runs on the virtual 8-device CPU mesh from conftest)."""

import jax
import numpy as np
import pytest

import __graft_entry__ as ge


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_product_parity(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    ge.dryrun_multichip(n)


def test_sharded_plans_equal_single_device():
    """Direct check (independent of the dryrun internals): shard_map of
    the product planning body over tiles == per-tile FramePlanner."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from oavif_jax.av1 import device_plan as ET
    from oavif_jax.av1.tables import ac_q

    rng = np.random.default_rng(5)
    t_dim = 4
    TS = 128
    nby = nbx = TS // 32
    qindex = 80
    tiles = []
    planes_by_tile = []
    for t in range(t_dim):
        planes = [
            rng.integers(0, 256, (TS, TS)).astype(np.int32) for _ in range(3)
        ]
        planes_by_tile.append(planes)
        fp = ET.FramePlanner(planes, 8)
        tiles.append(np.stack([np.asarray(d) for d in fp.dev]))
    tiles = jnp.asarray(np.stack(tiles))

    mesh = Mesh(np.array(jax.devices()[:t_dim]), ("tile",))

    def plan_tile(tp):
        t3 = tp[0]
        packed = ET._plan_device_body(
            t3[0], t3[1], t3[2], jnp.float32(ac_q(qindex, 8)),
            jnp.float32(qindex), nby, nbx, 8,
        )
        return packed[None]

    packed = np.asarray(
        jax.jit(
            jax.shard_map(
                plan_tile, mesh=mesh, in_specs=(P("tile"),),
                out_specs=P("tile"), check_vma=False,
            )
        )(tiles)
    )
    for t in range(t_dim):
        sharded = ET.unpack_plan(packed[t], nby, nbx)
        single = ET.FramePlanner(planes_by_tile[t], 8).plan(qindex)
        for k in single:
            np.testing.assert_array_equal(sharded[k], single[k])


def test_sharded_metric_matches_single():
    """Width-sharded SSIMULACRA2 (ppermute halo + psum'd norms +
    gather-when-small coarse scales) equals the single-device scorer."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 host devices")
    from oavif_jax.metric import compute_ssimulacra2
    from oavif_jax.metric.sharded import compute_ssimulacra2_sharded

    rng = np.random.default_rng(11)
    img = np.clip(
        np.kron(rng.integers(30, 225, (16, 64, 3)), np.ones((16, 8, 1)))
        + rng.normal(0, 6, (256, 512, 3)),
        0,
        255,
    ).astype(np.uint8)
    dist = np.clip(
        img.astype(np.int16) + rng.integers(-9, 10, img.shape), 0, 255
    ).astype(np.uint8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("tile",))
    s_sh = compute_ssimulacra2_sharded(img, dist, mesh)
    s_1 = compute_ssimulacra2(img, dist)
    assert abs(s_sh - s_1) < 0.05, (s_sh, s_1)


def test_planner_shape_bucketing_plan_equality():
    """Bucket-padded planner plans (shape shared across image sizes to
    amortize compiles) equal the direct unpadded device plan: prediction
    edges are left/top only, so real blocks never see the padding."""
    import jax.numpy as jnp
    import numpy as np

    from oavif_jax.av1 import device_plan as ET
    from oavif_jax.av1.tables import ac_q

    rng = np.random.default_rng(21)
    h, w = 320, 448  # 5x7 SBs -> bucketed to 8x8
    planes = [rng.integers(0, 256, (h, w)).astype(np.int32)
              for _ in range(3)]
    fp = ET.FramePlanner(planes, 8)
    assert (fp.psby, fp.psbx) == (8, 8)
    got = fp.plan(40)

    base = 128
    nby, nbx = fp.nby, fp.nbx
    devp = []
    for pl in planes:
        p = np.empty((fp.sby * 64 + 1, fp.sbx * 64 + 1), dtype=np.float32)
        p[1:, 1:] = pl[: fp.sby * 64, : fp.sbx * 64]
        p[0, :] = base - 1
        p[:, 0] = base + 1
        p[0, 0] = base
        devp.append(jnp.asarray(p))
    packed = np.asarray(
        ET._plan_device(
            devp[0], devp[1], devp[2],
            jnp.float32(ac_q(40, 8)), jnp.float32(40),
            nby, nbx, 8, fp.nmodes, fp.duel_level,
        )
    )
    want = ET.unpack_plan(packed, nby, nbx)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_loop_restoration_halo_exact():
    """Width-sharded Wiener restoration: the 7-tap horizontal support
    crosses shard boundaries via ppermute halos; the output must equal
    the host filter bit-for-bit (encode-side collective, SURVEY §2c)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from jax.sharding import Mesh

    from oavif_jax.av1.restoration import (
        apply_wiener, count_units, unit_size,
    )
    from oavif_jax.av1.restoration_sharded import apply_wiener_sharded

    rng = np.random.default_rng(7)
    h, w = 200, 512
    cdef = [np.asarray(128 + rng.integers(-80, 80, (h, w)), np.int32)
            for _ in range(3)]
    deblk = [np.asarray(c + rng.integers(-4, 5, (h, w)), np.int32)
             for c in cdef]
    taps = {0: (3, -7, 15, -2, 4, 28), 1: (0, -9, 25, 0, 4, 18), 2: None}
    mesh = Mesh(np.array(jax.devices()[:4]), ("tile",))
    out_sh = apply_wiener_sharded(cdef, deblk, h, w, taps, 8, mesh,
                                  axis="tile")
    size = unit_size(2)
    ur, uc = count_units(h, size), count_units(w, size)
    grids = {p: [[list(taps[p])] * uc for _ in range(ur)]
             for p in taps if taps[p]}
    types = tuple(2 if taps[p] else 0 for p in range(3))
    out_ref = apply_wiener(cdef, deblk, h, w, types, 2, grids, 8)
    for p in range(3):
        np.testing.assert_array_equal(out_sh[p], out_ref[p])

"""PyTorch port vs JAX package: voxel filters, submap assembly, scan-to-map
and one mapping step (loop closure off, and on without an attempt), on the
CPU, from the same JAX-made state pushed through ``convert.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.frontend.segmentation import image_projection as jproject
from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.graph import keyframes as jkf
from lego_loam_tpu.graph import submap_grid as jgrid
from lego_loam_tpu.io.npz_io import pack_raw_scan as jpack
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.match import voxelhash as jvox
from lego_loam_tpu.pipeline import mapping as jmap
from lego_loam_tpu.pipeline import odometry as jodo
from lego_loam_tpu.solve import scan2map as js2m
from lego_loam_tpu_torch.graph import keyframes as tkf
from lego_loam_tpu_torch.match import voxelhash as tvox
from lego_loam_tpu_torch.pipeline import mapping as tmap
from lego_loam_tpu_torch.solve import scan2map as ts2m
from torch_port_util import small_cfgs, tnp, to_np, to_torch

# a keyframe every mapping cycle, so two scans build a two-frame map; small
# map capacities keep the JAX side's CPU run short
JCFG, TCFG = small_cfgs(mapping=dict(
    keyframe_distance=0.05, max_map_corner=2048, max_map_surf=4096,
    surrounding_keyframe_search_num=4))
J_MAPPING_STEP = jax.jit(jmap.mapping_step, static_argnames=("cfg",))


def _points(n, seed, spread=6.0, offset=0.0):
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(-spread, spread, (n, 3)) + offset).astype(np.float32)
    return xyz, rng.random(n) > 0.15


@pytest.mark.parametrize("leaf,capacity,offset", [
    (0.4, 4096, 0.0),      # roomy
    (0.2, 512, 0.0),       # saturated: truncation in key order
    (0.4, 2048, -35.0),    # all-negative coordinates (key wrap the other way)
])
def test_voxel_downsample_matches_jax(leaf, capacity, offset):
    xyz, valid = _points(3000, 1, offset=offset)
    jx, jv, jn = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid),
                                       leaf, capacity, with_count=True)
    tx, tv, tn = tvox.voxel_downsample(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), leaf,
                                       capacity, with_count=True)
    assert int(tn) == int(jn)
    if capacity == 512:
        assert int(jn) > capacity
    np.testing.assert_array_equal(tnp(tv), np.asarray(jv))
    # centroids in the same (voxel-key) order
    np.testing.assert_allclose(tnp(tx), np.asarray(jx), atol=1e-5)


def test_voxel_payload_and_hash_variants_match_jax():
    xyz, valid = _points(2000, 2)
    payload = np.random.default_rng(3).random((2000, 2)).astype(np.float32)
    ref = jvox.voxel_downsample_with_payload(
        jnp.asarray(xyz), jnp.asarray(payload), jnp.asarray(valid), 0.4, 1024)
    got = tvox.voxel_downsample_with_payload(
        torch.from_numpy(xyz), torch.from_numpy(payload),
        torch.from_numpy(valid), 0.4, 1024)
    np.testing.assert_array_equal(tnp(got[2]), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(tnp(g), np.asarray(r), atol=1e-5)
    # batched = per-row calls
    bx = torch.from_numpy(xyz).reshape(4, 500, 3)
    bp = torch.from_numpy(payload).reshape(4, 500, 2)
    bv = torch.from_numpy(valid).reshape(4, 500)
    batched = tvox.voxel_downsample_with_payload_batched(bx, bp, bv, 0.4, 256)
    for i in range(4):
        one = tvox.voxel_downsample_with_payload(bx[i], bp[i], bv[i], 0.4, 256)
        for g, r in zip(batched, one):
            np.testing.assert_array_equal(tnp(g[i]), tnp(r))
    for two_probe in (True, False):
        ref = jvox.voxel_hash_downsample(
            jnp.asarray(xyz), jnp.asarray(payload), jnp.asarray(valid), 0.4,
            1024, two_probe=two_probe)
        got = tvox.voxel_hash_downsample(
            torch.from_numpy(xyz), torch.from_numpy(payload),
            torch.from_numpy(valid), 0.4, 1024, two_probe=two_probe)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(tnp(g), np.asarray(r))


def test_insert_keyframe_matches_jax_and_stops_when_full():
    jc, tc = small_cfgs(mapping=dict(max_keyframes=2))
    jstore = jkf.empty_store(jc)
    tstore = tkf.empty_store(tc, device="cpu")
    rng = np.random.default_rng(8)
    for k in range(3):                           # the third finds it full
        clouds = []
        for cap in (tkf.CORNER_CAP, tkf.SURF_CAP, tkf.OUTLIER_CAP,
                    tkf.SCAN2D_CAP):
            clouds += [rng.normal(size=(cap, 3)).astype(np.float32),
                       rng.random(cap) > 0.5]
        pose = rng.normal(size=6).astype(np.float32)
        stamp = np.float32(0.1 * k)
        jstore = jkf.insert_keyframe(jstore, jnp.asarray(pose),
                                     jnp.asarray(stamp),
                                     *map(jnp.asarray, clouds))
        tstore = tkf.insert_keyframe(tstore, torch.from_numpy(pose),
                                     torch.tensor(stamp),
                                     *map(torch.from_numpy, clouds))
    assert int(tstore.count) == int(jstore.count) == 2
    np.testing.assert_array_equal(tnp(tstore.pose), np.asarray(jstore.pose))
    np.testing.assert_array_equal(tnp(tstore.stamp), np.asarray(jstore.stamp))
    for name in tkf._BLOCKS:
        np.testing.assert_array_equal(tnp(getattr(tstore, name)),
                                      np.asarray(getattr(jstore, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def mapped():
    """JAX side: two scans through projection → odometry → mapping with a
    mapping cycle every scan; then the inputs of a third cycle."""
    scans, _, times = make_sequence(3, JCFG, seed=6, noise=0.01, speed=1.2)
    odo = jodo.init_state(JCFG)
    ms = jmap.init_state(JCFG)
    meta, clouds = ms.meta, ms.clouds
    assoc = None
    for k, (pts, t) in enumerate(zip(scans, times)):
        raw = jpack(pts, float(t), JCFG.pipeline.max_points)
        odo, assoc = jodo.odometry_step(odo, jproject(raw, JCFG), JCFG)
        if k == 2:
            break
        meta, row, pose, _ = J_MAPPING_STEP(meta, clouds, assoc, cfg=JCFG)
        clouds = jkf.apply_row(clouds, row)
        odo = odo.replace(odom=pose)                 # re-anchor, as slam does
        meta = meta.replace(bef_mapped=pose)
    assert int(meta.kf_count) == 2
    return meta, clouds, assoc


def test_assemble_submap_matches_jax(mapped):
    meta, clouds, assoc = mapped
    store = jkf.KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                              count=meta.kf_count, clouds=clouds)
    pred = jmap.predict_pose(meta, assoc.odom)
    jc, js, jsat = jkf.assemble_submap(store, pred, JCFG, window=4,
                                       with_sat=True)
    tmeta = to_torch("MappingMeta", meta)
    tstore = tkf.KeyframeStore(
        pose=tmeta.kf_pose, stamp=tmeta.kf_stamp, count=tmeta.kf_count,
        clouds=to_torch("KeyframeClouds", clouds))
    tpred = tmap.predict_pose(tmeta, torch.from_numpy(np.array(assoc.odom)))
    np.testing.assert_allclose(tnp(tpred), np.asarray(pred), atol=1e-5)
    tc, tsurf, tsat = tkf.assemble_submap(tstore, tpred, TCFG, window=4,
                                          with_sat=True)
    assert int(tsat) == int(jsat) == 0
    assert int(np.asarray(jc.valid).sum()) > 100
    for got, ref in ((tc, jc), (tsurf, js)):
        np.testing.assert_array_equal(tnp(got.valid), np.asarray(ref.valid))
        np.testing.assert_allclose(tnp(got.xyz), np.asarray(ref.xyz),
                                   atol=1e-4)


def test_scan_to_map_matches_jax(mapped):
    """Same scan clouds, same maps, same start ⇒ pose within 1e-3 (sums over
    thousands of residual rows in another order; closed-form Jacobian)."""
    meta, clouds, assoc = mapped
    m = JCFG.mapping
    store = jkf.KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                              count=meta.kf_count, clouds=clouds)
    pred = jmap.predict_pose(meta, assoc.odom)
    cmap, smap = jkf.assemble_submap(store, pred, JCFG, window=4)
    cds, cok = jvox.voxel_downsample(assoc.corner_xyz, assoc.corner_valid,
                                     m.corner_leaf_size, jkf.CORNER_CAP)
    sds, sok = jvox.voxel_downsample(assoc.surf_xyz, assoc.surf_valid,
                                     m.surf_leaf_size, jkf.SURF_CAP)
    # start away from the answer so the solver has work to do
    start = pred + jnp.asarray([0.004, -0.003, 0.01, 0.08, -0.05, 0.02])
    ref = np.asarray(js2m.scan_to_map(start, cds, cok, sds, sok, cmap, smap,
                                      JCFG))
    t = lambda a: torch.from_numpy(np.array(a))
    got = ts2m.scan_to_map(
        t(start), t(cds), t(cok), t(sds), t(sok),
        ts2m.MapCloud(t(cmap.xyz), t(cmap.valid)),
        ts2m.MapCloud(t(smap.xyz), t(smap.valid)), TCFG)
    assert np.abs(ref - np.asarray(start)).max() > 0.01      # it moved
    np.testing.assert_allclose(tnp(got), ref, atol=1e-3)
    # a thin map leaves the pose alone
    none = ts2m.MapCloud(t(cmap.xyz), torch.zeros_like(t(cmap.valid)))
    same = ts2m.scan_to_map(t(start), t(cds), t(cok), t(sds), t(sok), none,
                            ts2m.MapCloud(t(smap.xyz), t(smap.valid)), TCFG)
    np.testing.assert_array_equal(tnp(same), np.asarray(start))


def test_scan_to_map_searches_corner_and_surf_together(mapped, monkeypatch):
    """Every re-association is ONE grouped 5-NN call over (corner, surf),
    and the pose it leads to is the JAX package's (1e-3, as above)."""
    meta, clouds, assoc = mapped
    m = JCFG.mapping
    store = jkf.KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                              count=meta.kf_count, clouds=clouds)
    pred = jmap.predict_pose(meta, assoc.odom)
    cmap, smap = jkf.assemble_submap(store, pred, JCFG, window=4)
    cds, cok = jvox.voxel_downsample(assoc.corner_xyz, assoc.corner_valid,
                                     m.corner_leaf_size, jkf.CORNER_CAP)
    sds, sok = jvox.voxel_downsample(assoc.surf_xyz, assoc.surf_valid,
                                     m.surf_leaf_size, jkf.SURF_CAP)
    start = pred + jnp.asarray([0.004, -0.003, 0.01, 0.08, -0.05, 0.02])
    ref = np.asarray(js2m.scan_to_map(start, cds, cok, sds, sok, cmap, smap,
                                      JCFG))
    calls = []
    grouped = ts2m.knn5_grouped

    def counting(problems):
        calls.append([(p[0].shape[0], p[2].shape[0]) for p in problems])
        return grouped(problems)
    monkeypatch.setattr(ts2m, "knn5_grouped", counting)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ts2m.scan_to_map(
        t(start), t(cds), t(cok), t(sds), t(sok),
        ts2m.MapCloud(t(cmap.xyz), t(cmap.valid)),
        ts2m.MapCloud(t(smap.xyz), t(smap.valid)), TCFG)
    np.testing.assert_allclose(tnp(got), ref, atol=1e-3)
    every = TCFG.mapping.scan2map_reassoc_every
    assert 1 <= len(calls) <= -(-TCFG.mapping.scan2map_iters // max(every, 1))
    shapes = [(cds.shape[0], cmap.xyz.shape[0]),
              (sds.shape[0], smap.xyz.shape[0])]
    assert all(c == shapes for c in calls)


def test_mapping_step_matches_jax(mapped):
    meta, clouds, assoc = mapped
    rmeta, rrow, rpose, _ = to_np(
        J_MAPPING_STEP(meta, clouds, assoc, cfg=JCFG))
    tclouds = to_torch("KeyframeClouds", clouds)
    gmeta, grow, gpose, gdiag = tmap.mapping_step(
        to_torch("MappingMeta", meta), tclouds,
        to_torch("AssociationOut", assoc), TCFG)
    assert int(gmeta.kf_count) == int(rmeta.kf_count) == 3
    assert int(gmeta.factor_count) == int(rmeta.factor_count) == 2
    assert int(grow.idx) == int(rrow.idx) == 2
    for name in ("cycle", "kf_dropped", "factor_dropped", "map_sat"):
        assert int(getattr(gmeta, name)) == int(getattr(rmeta, name)), name
    np.testing.assert_allclose(tnp(gpose), rpose, atol=1e-3)
    np.testing.assert_allclose(tnp(gmeta.kf_pose), rmeta.kf_pose, atol=1e-3)
    np.testing.assert_array_equal(tnp(gmeta.kf_stamp), rmeta.kf_stamp)
    np.testing.assert_array_equal(tnp(gmeta.bef_mapped), rmeta.bef_mapped)
    g, r = gmeta.graph, rmeta.graph
    np.testing.assert_array_equal(tnp(g.i), r.i)
    np.testing.assert_array_equal(tnp(g.j), r.j)
    np.testing.assert_array_equal(tnp(g.valid), r.valid)
    np.testing.assert_array_equal(tnp(g.weight), r.weight)
    np.testing.assert_allclose(tnp(g.z), r.z, atol=2e-3)
    np.testing.assert_array_equal(tnp(g.prior), r.prior)
    # the row carries this scan's downsampled clouds, bit-equal layout
    for name in ("corner_valid", "surf_valid", "outlier_valid",
                 "scan2d_valid"):
        np.testing.assert_array_equal(tnp(getattr(grow, name)),
                                      getattr(rrow, name), err_msg=name)
    np.testing.assert_allclose(tnp(grow.surf), rrow.surf, atol=1e-5)
    assert not tnp(gdiag).any()
    # apply_row writes the row in place, and drops an index == capacity
    before = tnp(tclouds.corner).copy()
    tkf.apply_row(tclouds, tkf.null_row(tclouds.capacity, device="cpu"))
    np.testing.assert_array_equal(tnp(tclouds.corner), before)
    tkf.apply_row(tclouds, grow)
    np.testing.assert_array_equal(tnp(tclouds.corner[2]), tnp(grow.corner))
    np.testing.assert_array_equal(tnp(tclouds.corner[:2]), before[:2])


def test_loop_closure_on_is_refused(mapped):
    """Loop closure on (the ``vlp16()`` default) is no longer refused: a
    loop-on cycle reads its submap from the incremental grid and inserts the
    new keyframe into it, as the JAX package's ``mapping_step`` does.  Here
    the third cycle (cycle 2, so no closure attempt: those run every third
    cycle) on a grid holding the first two keyframes: the pose against the
    JAX package's scan-to-map on the grid's submap (1e-3, as above), and
    the grid after the insert against the JAX insert of the same row under
    the same pose (counts and tags exact, sums 1e-5)."""
    meta, clouds, assoc = mapped
    m = JCFG.mapping
    loop_on = dict(enable_loop_closure=True)
    jcfg = JCFG.replace(mapping=dataclasses.replace(m, **loop_on))
    tcfg = TCFG.replace(mapping=dataclasses.replace(TCFG.mapping, **loop_on))
    window = m.surrounding_keyframe_search_num
    grid = jgrid.empty_grid(jcfg)
    for k in range(2):
        pts = [jkf.as_points(getattr(clouds, b)[k]) if b[-5:] != "valid"
               else getattr(clouds, b)[k]
               for b in ("corner", "corner_valid", "surf", "surf_valid",
                         "outlier", "outlier_valid")]
        grid = jgrid.insert(grid, jnp.int32(k), meta.kf_pose[k], *pts,
                            cfg=jcfg, window=window)
    meta = meta.replace(grid=grid)
    assert int(meta.cycle) % m.loop_every_n_mapping != 0

    # the JAX package's loop-on cycle up to scan-to-map, by its parts
    pred = jmap.predict_pose(meta, assoc.odom)
    cds, cok = jvox.voxel_downsample(assoc.corner_xyz, assoc.corner_valid,
                                     m.corner_leaf_size, jkf.CORNER_CAP)
    sds, sok = jvox.voxel_downsample(assoc.surf_xyz, assoc.surf_valid,
                                     m.surf_leaf_size, jkf.SURF_CAP)
    ods, ook = jvox.voxel_downsample(assoc.outlier_xyz, assoc.outlier_valid,
                                     m.outlier_leaf_size, jkf.OUTLIER_CAP)
    tot, tok = jvox.voxel_downsample(jnp.concatenate([sds, ods]),
                                     jnp.concatenate([sok, ook]),
                                     m.surf_leaf_size, jkf.SURF_CAP)
    cmap, smap = jgrid.maps(grid, meta.kf_count, window)
    assert int(np.asarray(smap.valid).sum()) > 100
    ref = np.asarray(jse3.normalize_angles(js2m.scan_to_map(
        pred, cds, cok, tot, tok, cmap, smap, JCFG)))

    gmeta, grow, gpose, gdiag = tmap.mapping_step(
        to_torch("MappingMeta", meta), to_torch("KeyframeClouds", clouds),
        to_torch("AssociationOut", assoc), tcfg)
    np.testing.assert_allclose(tnp(gpose), ref, atol=1e-3)
    assert not tnp(gdiag).any()                     # no closure attempt
    assert int(gmeta.kf_count) == 3 and int(grow.idx) == 2
    assert int(gmeta.factor_count) == 2 and int(gmeta.map_sat) == 0

    rows = [jnp.asarray(tnp(getattr(grow, b)).reshape(-1, 3))
            if b[-5:] != "valid" else jnp.asarray(tnp(getattr(grow, b)))
            for b in ("corner", "corner_valid", "surf", "surf_valid",
                      "outlier", "outlier_valid")]
    want = to_np(jgrid.insert(grid, jnp.int32(2), jnp.asarray(tnp(gpose)),
                              *rows, cfg=jcfg, window=window))
    for name in ("corner_cnt", "corner_tag", "surf_cnt", "surf_tag"):
        np.testing.assert_array_equal(tnp(getattr(gmeta.grid, name)),
                                      getattr(want, name), err_msg=name)
    for name in ("corner_sum", "surf_sum"):
        np.testing.assert_allclose(tnp(getattr(gmeta.grid, name)),
                                   getattr(want, name), atol=1e-5)

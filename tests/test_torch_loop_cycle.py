"""PyTorch port vs JAX package: loop detection (``loop/detect.py``) and one
loop-on ``pipeline/mapping.py::mapping_step`` that closes a loop and
re-solves the pose graph, on a hand-built keyframe store whose latest
keyframe revisits the first.

Tolerances, stated at each assert: candidate index, masks, counters and
factor endpoints exact; gathered points 1e-5; the loop diagnostics' fitness
and correction 1e-2 relative (ICP on clouds that went through scan-to-map,
whose pose agrees to 1e-3 as in ``test_torch_mapping.py``); the loop
factor's measurement and the re-solved poses 2e-3 (the re-solve spreads that
difference over the chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.graph import keyframes as jkf
from lego_loam_tpu.graph import posegraph as jpg
from lego_loam_tpu.graph import submap_grid as jgrid
from lego_loam_tpu.loop import detect as jdet
from lego_loam_tpu.pipeline import mapping as jmap
from lego_loam_tpu_torch.core import se3 as tse3
from lego_loam_tpu_torch.graph import keyframes as tkf
from lego_loam_tpu_torch.graph import submap_grid as tgrid
from lego_loam_tpu_torch.loop import detect as tdet
from lego_loam_tpu_torch.pipeline import mapping as tmap
from torch_port_util import small_cfgs, tnp, to_np, to_torch

# loop closure on; a closure needs 4 s of age (the lap below takes ~8.6 s)
# and every accepted closure re-solves (negative relinearisation threshold).
# The ICP source and iteration caps are cut because the JAX side's CPU
# 5-NN costs about a second per iteration at these shapes.
JCFG, TCFG = small_cfgs(mapping=dict(
    enable_loop_closure=True, loop_closure_time_gap=4.0,
    loop_relin_trans=-1.0, max_keyframes=32, max_loop_factors=16,
    max_map_corner=2048, max_map_surf=4096, loop_history_cap=16384,
    loop_source_cap=256, icp_max_iters=4, surrounding_keyframe_search_num=8))
WINDOW = JCFG.mapping.surrounding_keyframe_search_num
J_MAPPING_STEP = jax.jit(jmap.mapping_step, static_argnames=("cfg",))


def _t(a):
    return torch.from_numpy(np.array(a))


N_KF = 17          # keyframes at scans 4, 9, …, 84; scan 89 revisits scan 4


@pytest.fixture(scope="module")
def lap():
    """The state before a mapping cycle that revisits the start of one lap
    of the loop-closure test sequence (radius 2.2 m, 1.6 m/s), hand-built:
    keyframe k is scan 5k+4, its clouds the scan's points voxel-filtered in
    the sensor frame, its pose the true one with a growing yaw and position
    drift; the grid holds every keyframe's insert, the graph the prior and
    the odometry chain.  The next cycle's inputs come from scan 89, near
    keyframe 0.  Built with the port's functions (each held against the JAX
    package's elsewhere in these tests) and handed to both sides through
    NumPy.  Returns (JAX meta, JAX clouds, JAX AssociationOut)."""
    from lego_loam_tpu.core.types import AssociationOut
    from lego_loam_tpu_torch import convert
    from lego_loam_tpu_torch.graph import posegraph as tpg
    from lego_loam_tpu_torch.io.synthetic import make_sequence as tmake
    from lego_loam_tpu_torch.match.voxelhash import voxel_downsample

    scans, gt, times = tmake(90, TCFG, seed=33, noise=0.01, radius=2.2,
                             speed=1.6)
    m = TCFG.mapping
    g = torch.from_numpy(np.asarray(gt, np.float32))
    gt_rel = tse3.relative(g[0], g)

    def points(i):
        pts = np.asarray(scans[i], np.float32)
        pts = torch.from_numpy(pts[np.isfinite(pts).all(1)])
        return pts, torch.ones(pts.shape[0], dtype=torch.bool)

    def drifted(i, k):
        return gt_rel[i] + torch.tensor([0, 0, 0.002 * k, 0.01 * k,
                                         0.01 * k, 0])

    state = tmap.init_state(TCFG, "cpu")
    meta = state.meta
    store = tkf.KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                              count=meta.kf_count, clouds=state.clouds)
    grid, graph, fcount = meta.grid, meta.graph, meta.factor_count
    none3 = (torch.zeros((tkf.OUTLIER_CAP, 3)),
             torch.zeros((tkf.OUTLIER_CAP,), dtype=torch.bool))
    none2d = (torch.zeros((tkf.SCAN2D_CAP, 3)),
              torch.zeros((tkf.SCAN2D_CAP,), dtype=torch.bool))
    odom_w = torch.tensor(m.odom_factor_weight)
    for k in range(N_KF):
        xyz, ok = points(5 * k + 4)
        c, cv = voxel_downsample(xyz, ok, 0.8, tkf.CORNER_CAP)
        s, sv = voxel_downsample(xyz, ok, 0.6, tkf.SURF_CAP)
        pose = drifted(5 * k + 4, k)
        k32 = torch.tensor(k, dtype=torch.int32)
        store = tkf.insert_keyframe(store, pose,
                                    torch.tensor(float(times[5 * k + 4])),
                                    c, cv, s, sv, *none3, *none2d)
        grid = tgrid.insert(grid, k32, pose, c, cv, s, sv, *none3, TCFG,
                            WINDOW)
        if k == 0:
            graph = graph.replace(prior=pose)
        else:
            z = tse3.relative(drifted(5 * k - 1, k - 1), pose)
            graph, fcount = tpg.add_factor(graph, fcount, k32 - 1, k32, z,
                                           odom_w)
    last = drifted(5 * N_KF - 1, N_KF - 1)
    meta = meta.replace(
        kf_pose=store.pose, kf_stamp=store.stamp, kf_count=store.count,
        grid=grid, graph=graph, factor_count=fcount,
        cycle=torch.tensor(3 * N_KF, dtype=torch.int32), aft_mapped=last,
        bef_mapped=last, initialized=torch.tensor(True))

    # the next cycle: scan 89, odometry carrying the same drift
    f, P = TCFG.feature, TCFG.pipeline
    H = TCFG.laser.num_horizontal_scans
    xyz, ok = points(89)
    corner, corner_ok = voxel_downsample(xyz, ok, 0.3, f.max_less_sharp)
    surf, surf_ok = voxel_downsample(xyz, ok, 0.2, f.max_less_flat)

    def jtree(obj):
        return jax.tree.map(jnp.asarray, convert.to_numpy_tree(obj))

    jm = jtree(meta)
    jmeta = jmap.MappingMeta(**{
        **jm, "grid": jgrid.SubmapGrid(**jm["grid"]),
        "graph": jpg.FactorGraph(**jm["graph"])})
    jclouds = jkf.KeyframeClouds(**jtree(store.clouds))
    assoc = AssociationOut(
        corner_xyz=jnp.asarray(tnp(corner)), corner_valid=jnp.asarray(
            tnp(corner_ok)), surf_xyz=jnp.asarray(tnp(surf)),
        surf_valid=jnp.asarray(tnp(surf_ok)),
        outlier_xyz=jnp.zeros((P.max_outlier, 3)),
        outlier_valid=jnp.zeros((P.max_outlier,), bool),
        odom=jnp.asarray(tnp(drifted(89, N_KF))),
        scan2d_xyz=jnp.zeros((H, 3)), scan2d_valid=jnp.zeros((H,), bool),
        stamp=jnp.float32(times[89]))
    return jmeta, jclouds, assoc


def test_find_candidate_and_gathers_match_jax(lap):
    """Candidate, history target and latest-keyframe source of an attempt
    from keyframe 16 (8 s into the lap) — index and masks exact, points
    1e-5 — and no candidate when nothing is old enough."""
    meta, clouds, _ = lap
    jstore = jkf.KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                               count=meta.kf_count, clouds=clouds)
    tstore = tkf.KeyframeStore(
        pose=_t(meta.kf_pose), stamp=_t(meta.kf_stamp),
        count=_t(meta.kf_count), clouds=to_torch("KeyframeClouds", clouds))
    latest = N_KF - 1
    for stamp, want in ((meta.kf_stamp[latest], True),
                        (meta.kf_stamp[latest] - 6.0, False)):
        jf, ji = jdet.find_candidate(jstore, meta.kf_pose[latest], stamp,
                                     JCFG)
        tf, ti = tdet.find_candidate(tstore, _t(meta.kf_pose[latest]),
                                     _t(stamp), TCFG)
        assert bool(tf) == bool(jf) == want
        assert int(ti) == int(ji)
    assert int(ti) <= 2
    m = JCFG.mapping
    jt = jax.jit(jdet._gather_history, static_argnames="cfg")(
        jstore, None, ji, cfg=JCFG)
    tt = tdet._gather_history(tstore, None, ti, TCFG)
    np.testing.assert_array_equal(tnp(tt[1]), np.asarray(jt[1]))
    np.testing.assert_allclose(tnp(tt[0]), np.asarray(jt[0]), atol=1e-5)
    assert int(tt[2]) == int(jt[2]) == 0 and tnp(tt[1]).sum() > 1000
    js = jdet._gather_latest(jstore, None, jnp.int32(latest),
                             m.loop_source_cap)
    ts = tdet._gather_latest(tstore, None, torch.tensor(latest),
                             m.loop_source_cap)
    np.testing.assert_array_equal(tnp(ts[1]), np.asarray(js[1]))
    np.testing.assert_allclose(tnp(ts[0]), np.asarray(js[0]), atol=1e-5)
    assert tnp(ts[1]).all()          # surf survived the source_cap cut


def test_loop_on_mapping_step_closes_the_loop_like_jax(lap):
    """The cycle inserts keyframe 17 near keyframe 0, attempts a closure
    (cycle 51 is a multiple of 3), accepts it, adds the loop factor and
    re-solves: ``found``, ``old_idx``, the new factor, ``loop_diag`` and the
    corrected poses agree with the JAX package's."""
    meta, clouds, assoc = lap
    rmeta, rrow, rpose, rdiag = to_np(
        J_MAPPING_STEP(meta, clouds, assoc, cfg=JCFG))
    resolves = tmap.resolve_count
    gmeta, grow, gpose, gdiag = tmap.mapping_step(
        to_torch("MappingMeta", meta), to_torch("KeyframeClouds", clouds),
        to_torch("AssociationOut", assoc), TCFG)
    assert tmap.resolve_count == resolves + 1
    gdiag = tnp(gdiag)
    # [attempted, accepted, fitness, corr_trans, corr_rot, old, latest, relin]
    assert gdiag[0] == rdiag[0] == 1.0 and gdiag[1] == rdiag[1] == 1.0
    assert gdiag[5] == rdiag[5] and gdiag[6] == rdiag[6] == N_KF
    assert gdiag[7] == rdiag[7] == 1.0
    np.testing.assert_allclose(gdiag[2:5], rdiag[2:5], rtol=1e-2, atol=2e-3)
    assert int(gmeta.kf_count) == int(rmeta.kf_count) == N_KF + 1
    assert int(gmeta.factor_count) == int(rmeta.factor_count) == N_KF + 1
    for name in ("kf_dropped", "factor_dropped", "map_sat", "cycle"):
        assert int(getattr(gmeta, name)) == int(getattr(rmeta, name)), name
    g, r = gmeta.graph, rmeta.graph
    f = N_KF                                          # the loop factor's slot
    assert int(g.i[f]) == int(r.i[f]) == N_KF
    assert int(g.j[f]) == int(r.j[f]) == int(rdiag[5])
    assert bool(g.valid[f]) and bool(r.valid[f])
    np.testing.assert_allclose(tnp(g.z[f]), r.z[f], atol=2e-3)
    np.testing.assert_allclose(tnp(g.weight[f]), r.weight[f], rtol=1e-2)
    # the corrected poses (re-solved chain) and the carried mapped pose
    n = N_KF + 1
    np.testing.assert_allclose(tnp(gmeta.kf_pose)[:n], rmeta.kf_pose[:n],
                               atol=2e-3)
    np.testing.assert_allclose(tnp(gpose), rpose, atol=2e-3)
    # the rebuilt grid: the same live voxels
    for name in ("corner_tag", "surf_tag"):
        same = (tnp(getattr(gmeta.grid, name))
                == getattr(rmeta.grid, name)).mean()
        assert same > 0.99, (name, same)

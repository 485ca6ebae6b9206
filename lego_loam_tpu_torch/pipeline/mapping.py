"""Stage 3 — map optimization pipeline step.

The ``MapOptimization::run`` loop body (``mapOptmization.cpp:1521-1570``) as
one step function: pose prediction from the latest odometry + mapping
correction, submap assembly, scan-to-map GN, keyframe insertion.  Without
closures the iSAM2 chain (prior + between factors only) has the composed
odometry as its exact solution (``saveKeyFramesAndFactor``, :1335-1478), so
keyframe poses here come straight from scan-to-map.

Both submap modes of the JAX package are ported.  Loop closure ON (the
``vlp16()`` default): the latest-N window is read from the incremental voxel
grid (``graph/submap_grid.py``), a keyframe is inserted into it, and every
``loop_every_n_mapping`` cycles a closure is attempted (``loop/detect.py``);
an accepted closure adds a loop factor and, past the relinearisation
threshold, re-solves the pose graph (``graph/posegraph.py``), carries the
correction onto the current pose and rebuilds the grid.  Loop closure OFF
(the upstream project's shipped default): the 50 m radius submap is
assembled from the keyframe store every cycle.

Where the JAX package branches with ``lax.cond``, the port reads the
condition on the host (one counted ``host_bool``) only in front of costly
work — the loop attempt, the re-solve; cheap conditional updates (the
keyframe insert, the grid insert, the factor writes) are masked writes.

State is split as in the JAX package: :class:`MappingMeta` (poses, graph,
counters — small, never written in place) and the big
:class:`KeyframeClouds` blocks, which ``mapping_step`` only reads; the
inserted row comes back as a :class:`KeyframeRow` for the caller to write
with ``keyframes.apply_row`` (in place).

Stage 4 (TransformFusion, ``transformFusion.cpp``) collapses to
:func:`fuse_pose` — one closed-form composition at odometry rate.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading

import torch

from ..core import graphs, se3
from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, host_bool, resolve_device, stage
from ..core.types import AssociationOut, Container
from ..distributed.sharded_pgo import optimize_poses_sharded
from ..graph import submap_grid
from ..graph.keyframes import (CORNER_CAP, OUTLIER_CAP, SCAN2D_CAP,
                               SURF_CAP, KeyframeClouds, KeyframeStore,
                               empty_clouds, make_row, mesh_of,
                               put_row, submap_of_rows, submap_rows,
                               surrounding, take_row)
from ..graph.posegraph import (FactorGraph, add_factor, empty_graph,
                               optimize_poses)
from ..loop.detect import detect_and_verify
from ..match.voxelhash import voxel_downsample
from ..solve.scan2map import map_is_thick, refine

Tensor = torch.Tensor

resolve_count = 0         # +1 per pose-graph re-solve after a loop closure
pcg_iteration_count = 0   # PCG iterations summed over those re-solves
_count_lock = threading.Lock()


@dataclasses.dataclass
class MappingMeta(Container):
    """Everything in the mapping state EXCEPT the keyframe cloud blocks."""

    kf_pose: Tensor         # (K, 6) map-frame keyframe poses
    kf_stamp: Tensor        # (K,)
    kf_count: Tensor        # () int32
    grid: submap_grid.SubmapGrid   # incremental world-frame submap
    graph: FactorGraph
    factor_count: Tensor    # () int32
    cycle: Tensor           # () int32 mapping cycles run (loop cadence)
    aft_mapped: Tensor      # (6,) map-frame pose at last mapping step
    bef_mapped: Tensor      # (6,) odometry pose at last mapping step
    initialized: Tensor     # () bool
    # Saturation counters — the reference grows its keyframe arrays and
    # iSAM2 graph without bound (mapOptmization.cpp:1431-1474); our
    # fixed-capacity stores must NEVER silently drop.  A nonzero counter
    # means max_keyframes / max_loop_factors is undersized for the run.
    kf_dropped: Tensor      # () int32 keyframes lost to capacity
    factor_dropped: Tensor  # () int32 factors lost to capacity
    map_sat: Tensor         # () int32 world-frame voxel-filter overflow:
    #   voxels truncated by max_map_corner/max_map_surf (radius-submap
    #   assembly) or loop_history_cap (loop-ICP target).  Key-order
    #   truncation of a WORLD-frame aggregate censors the map at an x-plane
    #   (match/voxelhash.py) — nonzero means those capacities are undersized
    #   for the run.


@dataclasses.dataclass
class MappingState(Container):
    meta: MappingMeta
    clouds: KeyframeClouds

    @property
    def store(self) -> KeyframeStore:
        return KeyframeStore(pose=self.meta.kf_pose,
                             stamp=self.meta.kf_stamp,
                             count=self.meta.kf_count, clouds=self.clouds)

    @property
    def graph(self) -> FactorGraph:
        return self.meta.graph

    @property
    def factor_count(self) -> Tensor:
        return self.meta.factor_count

    @property
    def aft_mapped(self) -> Tensor:
        return self.meta.aft_mapped


def init_state(cfg: LegoLoamConfig, device: DeviceLike = None,
               mesh=None) -> MappingState:
    """Fresh mapping state on ``device``; with ``mesh`` the keyframe cloud
    blocks are row-sharded over it."""
    device = resolve_device(device)
    m = cfg.mapping
    K = m.max_keyframes

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    meta = MappingMeta(
        kf_pose=f32(K, 6), kf_stamp=f32(K), kf_count=i32(),
        grid=submap_grid.empty_grid(cfg, device),
        graph=empty_graph(K + m.max_loop_factors, device),
        factor_count=i32(), cycle=i32(),
        aft_mapped=f32(6), bef_mapped=f32(6),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        kf_dropped=i32(), factor_dropped=i32(), map_sat=i32())
    return MappingState(meta=meta, clouds=empty_clouds(cfg, device, mesh))


def predict_pose(meta: MappingMeta, odom: Tensor) -> Tensor:
    """``transformAssociateToMap`` (``mapOptmization.cpp:264-387``) in one
    line of SE(3): carry the last mapping correction forward."""
    return se3.normalize_angles(
        se3.compose(meta.aft_mapped, se3.relative(meta.bef_mapped, odom)))


def fuse_pose(state: MappingState, odom: Tensor) -> Tensor:
    """Stage 4, ``TransformFusion::transformAssociateToMap``
    (``transformFusion.cpp:64-185``): drift-corrected pose at odometry
    rate."""
    return predict_pose(state.meta, odom)


@dataclasses.dataclass
class _Scan(Container):
    """The cycle's scan clouds after the per-scan voxel filters."""

    corner: Tensor
    corner_ok: Tensor
    surf: Tensor
    surf_ok: Tensor
    outlier: Tensor
    outlier_ok: Tensor
    surf_total: Tensor      # surf + outlier re-filtered: scan-to-map's
    surf_total_ok: Tensor   # surf queries
    scan2d: Tensor
    scan2d_ok: Tensor


def _downsample(assoc: AssociationOut, cfg: LegoLoamConfig) -> _Scan:
    """downsampleCurrentScan (:999-1026).  Exact sort-based centroids here:
    these clouds become the PERSISTENT keyframe blocks (and scan-to-map
    queries), where any loss compounds over the whole trajectory."""
    m = cfg.mapping
    corner_ds, corner_ok = voxel_downsample(
        assoc.corner_xyz, assoc.corner_valid, m.corner_leaf_size,
        CORNER_CAP)
    surf_ds, surf_ok = voxel_downsample(
        assoc.surf_xyz, assoc.surf_valid, m.surf_leaf_size, SURF_CAP)
    outlier_ds, outlier_ok = voxel_downsample(
        assoc.outlier_xyz, assoc.outlier_valid, m.outlier_leaf_size,
        OUTLIER_CAP)
    # surf-total = surf + outlier re-filtered at 0.4 (:1014-1024)
    surf_total, surf_total_ok = voxel_downsample(
        torch.cat([surf_ds, outlier_ds], dim=0),
        torch.cat([surf_ok, outlier_ok], dim=0),
        m.surf_leaf_size, SURF_CAP)
    scan2d_ds, scan2d_ok = voxel_downsample(
        assoc.scan2d_xyz, assoc.scan2d_valid, 0.1, SCAN2D_CAP)
    return _Scan(corner_ds, corner_ok, surf_ds, surf_ok, outlier_ds,
                 outlier_ok, surf_total, surf_total_ok, scan2d_ds, scan2d_ok)


def _prologue_grid(meta: MappingMeta, assoc: AssociationOut,
                   cfg: LegoLoamConfig):
    """The cycle up to scan-to-map with loop closure ON: the predicted pose,
    the scan's voxel filters, the latest-N window read from the persistent
    incremental voxel grid (:863-913; no re-assembly of N keyframes) and
    the thin-map gate.  Returns (pred, scan, corner_map, surf_map, thick)."""
    corner_map, surf_map = submap_grid.maps(
        meta.grid, meta.kf_count, cfg.mapping.surrounding_keyframe_search_num)
    return (predict_pose(meta, assoc.odom), _downsample(assoc, cfg),
            corner_map, surf_map, map_is_thick(corner_map, surf_map, cfg))


def _prologue_radius(meta: MappingMeta, assoc: AssociationOut,
                     cfg: LegoLoamConfig):
    """The cycle's start with loop closure OFF: the predicted pose, the
    scan's voxel filters and the submap's keyframes.  Returns (pred, scan,
    sel_idx, sel_ok)."""
    pred = predict_pose(meta, assoc.odom)
    sel_idx, sel_ok = surrounding(meta.kf_pose, meta.kf_count, pred, cfg,
                                  cfg.mapping.surrounding_keyframe_search_num)
    return pred, _downsample(assoc, cfg), sel_idx, sel_ok


def _radius_submap(meta: MappingMeta, sel_idx, sel_ok, rows,
                   cfg: LegoLoamConfig):
    """The 50 m radius submap from its keyframes' rows, the saturation
    counter and the thin-map gate: (corner_map, surf_map, map_sat,
    thick)."""
    corner_map, surf_map, sat = submap_of_rows(meta.kf_pose, sel_idx, sel_ok,
                                               rows, cfg)
    return (corner_map, surf_map, meta.map_sat + sat.to(meta.map_sat.dtype),
            map_is_thick(corner_map, surf_map, cfg))


def _tail(meta: MappingMeta, pose: Tensor, scan: _Scan, stamp: Tensor,
          odom: Tensor, cfg: LegoLoamConfig):
    """The cycle after scan-to-map: the keyframe decision and its row, the
    grid insert (loop closure on), the factors, and whether to attempt a
    closure.  Returns (new meta, KeyframeRow, run_loop, loop_diag)."""
    m = cfg.mapping
    pose = se3.normalize_angles(pose)

    # saveKeyFramesAndFactor (:1335-1478): keyframe iff moved ≥ 0.3 m
    K = meta.kf_pose.shape[0]
    last_i = torch.clamp(meta.kf_count - 1, min=0)
    last_kf = take_row(meta.kf_pose, last_i)
    dp = pose[3:] - last_kf[3:]
    moved = torch.sqrt(torch.sum(dp * dp))
    is_kf = (~meta.initialized) | (moved >= m.keyframe_distance)
    insert = is_kf & (meta.kf_count < K)

    idx = torch.where(insert, meta.kf_count, K).to(torch.int32)  # K ⇒ dropped
    row = make_row(idx, scan.corner, scan.corner_ok, scan.surf, scan.surf_ok,
                   scan.outlier, scan.outlier_ok, scan.scan2d, scan.scan2d_ok)
    kf_count = meta.kf_count + insert.to(torch.int32)

    grid = meta.grid
    if m.enable_loop_closure:
        grid = submap_grid.insert(
            grid, meta.kf_count, pose, scan.corner, scan.corner_ok,
            scan.surf, scan.surf_ok, scan.outlier, scan.outlier_ok, cfg,
            m.surrounding_keyframe_search_num, enable=insert)

    # factors: PriorFactor on node 0 (:1363-1369) with the first keyframe,
    # BetweenFactor(prev, new) (:1384-1398) with every later one
    odom_w = graphs.constant(m.odom_factor_weight, torch.float32,
                             pose.device)
    cap_f = meta.graph.i.shape[0]
    first = insert & (meta.kf_count == 0)
    later = insert & (meta.kf_count != 0)
    graph = meta.graph.replace(
        prior=torch.where(first, pose, meta.graph.prior))
    fdrop = meta.factor_dropped + (
        later & (meta.factor_count >= cap_f)).to(torch.int32)
    graph, fcount = add_factor(
        graph, meta.factor_count, last_i, meta.kf_count,
        se3.relative(last_kf, pose), odom_w, enable=later)

    new = MappingMeta(
        kf_pose=put_row(meta.kf_pose, idx, pose),
        kf_stamp=put_row(meta.kf_stamp, idx, stamp), kf_count=kf_count,
        grid=grid, graph=graph, factor_count=fcount, cycle=meta.cycle + 1,
        aft_mapped=pose, bef_mapped=odom,
        initialized=torch.ones_like(meta.initialized),
        kf_dropped=meta.kf_dropped + (is_kf & ~insert).to(torch.int32),
        factor_dropped=fdrop, map_sat=meta.map_sat)
    # a closure is attempted every loop_every_n_mapping cycles (:1562-1568)
    run_loop = (meta.cycle % m.loop_every_n_mapping == 0) & (kf_count > 2)
    return (new, row, run_loop,
            torch.zeros((8,), dtype=torch.float32, device=pose.device))


def mapping_step(meta: MappingMeta, clouds: KeyframeClouds,
                 assoc: AssociationOut, cfg: LegoLoamConfig):
    """One mapping cycle.

    ``clouds`` (whole or row-sharded blocks, read through
    ``keyframes.take_rows``) is read-only; row-sharded blocks run a loop
    closure's pose-graph re-solve factor-sharded over their mesh
    (``distributed/sharded_pgo.py``), whole ones on one device.  The
    (possibly dropped) inserted keyframe row comes back for the caller to
    ``apply_row``.  Returns
    (new_meta, KeyframeRow, mapped_pose (6,), loop_diag (8,)):
    ``loop_diag`` = [attempted, accepted, fitness, |corr translation|,
    max |corr rotation|, old_idx, latest_idx, +1 re-solved / −1 rejected as
    implausible / 0] of this cycle's loop attempt, zeros without one.
    None of them shares storage with ``meta`` or with a graph's buffers.

    On a CUDA card the cycle's fixed-shape chains replay from CUDA graphs
    (``core/graphs.py``): the prologue up to scan-to-map, scan-to-map's
    iterations (``solve/scan2map.py::refine``, around an eager K2 launch)
    and the tail after it.  Eager: with loop closure off the gather of the
    submap's keyframe rows (the keyframe blocks are never a graph's input),
    the loop attempt, and the copies of the results out of the graphs'
    buffers.

    Host reads: the convergence reads inside scan-to-map and its thin-map
    gate; with loop closure on, one read per cycle for "attempt a
    closure", then inside an attempt one for "is there a candidate", one
    per ICP iteration, one for "re-solve", and the PCG's reads of a
    re-solve.
    """
    m = cfg.mapping
    # extractSurroundingKeyFrames (:857-996) has two modes:
    if m.enable_loop_closure:
        # loop-ON: latest-N window (:863-913), read from the grid
        pred, scan, corner_map, surf_map, thick = graphs.run(
            _prologue_grid, meta, assoc, cfg)
    else:
        # loop-OFF (the reference's default config): 50 m keypose RADIUS
        # search (:917-986) — a revisit must re-associate against the OLD
        # map, which a latest-N window cannot provide.  Assembled from the
        # keyframe store each cycle; its rows are gathered eagerly.
        pred, scan, sel_idx, sel_ok = graphs.run(
            _prologue_radius, meta, assoc, cfg)
        corner_map, surf_map, map_sat, thick = graphs.run(
            _radius_submap, meta, sel_idx, sel_ok,
            submap_rows(clouds, sel_idx), cfg)
        meta = meta.replace(map_sat=map_sat)

    pose = refine(pred, scan.corner, scan.corner_ok, scan.surf_total,
                  scan.surf_total_ok, corner_map, surf_map, thick, cfg)
    new, row, run_loop, loop_diag = graphs.run(
        _tail, meta, pose, scan, assoc.stamp, assoc.odom, cfg)

    if m.enable_loop_closure and host_bool(run_loop):
        with stage("loop_attempt", pose.device):
            store = KeyframeStore(pose=new.kf_pose, stamp=new.kf_stamp,
                                  count=new.kf_count, clouds=clouds)
            res = detect_and_verify(store, row, assoc.stamp, cfg,
                                    robot_pose=new.aft_mapped)
        new, loop_diag = _close_loop(res, new, clouds, cfg)
    return graphs.owned((new, row, new.aft_mapped, loop_diag))


def _close_loop(res, meta: MappingMeta, clouds: KeyframeClouds,
                cfg: LegoLoamConfig):
    """The rest of a loop attempt (``performLoopClosure`` :767-854 and
    ``correctPoses`` :1481-1511): the diagnostics vector, the loop factor
    (a masked write: added iff the closure was accepted) and, iff accepted
    AND the ICP correction exceeds the relinearisation threshold, the
    pose-graph re-solve, the carried correction and the grid rebuild.
    Returns (new meta, loop_diag)."""
    global resolve_count, pcg_iteration_count
    m = cfg.mapping
    # The gate measures the RAW ICP correction in the latest keyframe's
    # frame (corrected = corr ∘ kf_pose) — a world-frame pose difference
    # would conjugate the rotation through the pose and pick up a phantom
    # |corr_rot|·|t_pose| translation.
    corr = res["corr"]
    corr_trans = torch.sqrt(torch.sum(corr[3:] ** 2))
    corr_rot = torch.max(torch.abs(corr[:3]))
    do_relin = ((corr_trans > m.loop_relin_trans)
                | (corr_rot > math.radians(m.loop_relin_rot_deg)))
    found = res["found"]
    one = torch.ones((), dtype=torch.float32, device=corr.device)
    diag = torch.stack([
        one,
        found.to(torch.float32),
        torch.clamp(res["fitness"], max=1e6),
        corr_trans,
        corr_rot,
        res["old_idx"].to(torch.float32),
        res["latest_idx"].to(torch.float32),
        # +1 = accepted closure will re-solve; −1 = closure passed the
        # fitness gate but was REJECTED as implausible
        (found & do_relin).to(torch.float32)
        - res["implausible"].to(torch.float32)])

    cap_f = meta.graph.i.shape[0]
    w = torch.full((6,), 1.0, dtype=torch.float32, device=corr.device) \
        / torch.sqrt(torch.clamp(res["fitness"], min=1e-4))
    fdrop = meta.factor_dropped + (
        found & (meta.factor_count >= cap_f)).to(torch.int32)
    graph, fcount = add_factor(meta.graph, meta.factor_count,
                               res["latest_idx"], res["old_idx"], res["z"], w,
                               enable=found)
    meta = meta.replace(
        graph=graph, factor_count=fcount, factor_dropped=fdrop,
        map_sat=meta.map_sat + res["sat"].to(meta.map_sat.dtype))

    if host_bool(found & do_relin):
        # The cyclic-reduction chain preconditioner solves the stiff
        # odometry chain exactly, leaving PCG only the low-rank loop-factor
        # perturbation; warm-started from the current poses the solve is
        # incremental (iSAM2's role): 2-3 GN steps suffice.
        dev = meta.kf_pose.device
        latest = res["latest_idx"]
        old_latest = take_row(meta.kf_pose, latest)
        mesh = mesh_of(clouds)
        solve = (optimize_poses if mesh is None else functools.partial(
            optimize_poses_sharded, mesh=mesh))
        with stage("loop_resolve", dev):
            new_poses, iters = solve(meta.kf_pose, meta.kf_count, graph,
                                     gn_iters=3, pcg_iters=64,
                                     return_iters=True)
        with _count_lock:
            resolve_count += 1
            pcg_iteration_count += sum(iters)
        # carry the correction onto the CURRENT pose (which may be up to
        # keyframe_distance ahead of the last keyframe)
        delta = se3.compose(take_row(new_poses, latest),
                            se3.inverse(old_latest))
        aft = se3.normalize_angles(se3.compose(delta, meta.aft_mapped))
        # the world-frame submap grid is stale after the rewrite —
        # re-scatter it under the corrected poses (the reference clears its
        # transformed-cloud cache here, :1497)
        with stage("grid_rebuild", dev):
            grid = submap_grid.rebuild(new_poses, meta.kf_count, clouds, cfg,
                                       window=m.surrounding_keyframe_search_num)
        meta = meta.replace(kf_pose=new_poses, grid=grid, aft_mapped=aft)
    return meta, diag

"""Stage 3 — map optimization pipeline step.

The ``MapOptimization::run`` loop body (``mapOptmization.cpp:1521-1570``) as
one step function: pose prediction from the latest odometry + mapping
correction, submap assembly, scan-to-map GN, keyframe insertion.  Without
closures the iSAM2 chain (prior + between factors only) has the composed
odometry as its exact solution (``saveKeyFramesAndFactor``, :1335-1478), so
keyframe poses here come straight from scan-to-map.

Only the loop-closure-OFF configuration (``enable_loop_closure=False``, the
upstream project's shipped default) is ported: the 50 m radius submap is
assembled from the keyframe store every cycle and the prior/between factors
are recorded.  ``enable_loop_closure=True`` needs the incremental submap
grid, loop detection + ICP and the pose-graph solver, which a later slice of
the port adds; it raises ``NotImplementedError`` until then, and
``MappingMeta.grid`` stays ``None``.

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
from typing import Any

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device
from ..core.types import AssociationOut, Container
from ..graph.keyframes import (CORNER_CAP, OUTLIER_CAP, SCAN2D_CAP,
                               SURF_CAP, KeyframeClouds, KeyframeStore,
                               assemble_submap, empty_clouds, make_row,
                               put_row, take_row)
from ..graph.posegraph import FactorGraph, add_factor, empty_graph
from ..match.voxelhash import voxel_downsample
from ..solve.scan2map import scan_to_map

Tensor = torch.Tensor

_LOOP_MSG = ("enable_loop_closure=True is not ported yet: the loop-closure "
             "slice (incremental submap grid, loop detection + ICP, "
             "pose-graph solver) comes later; run with "
             "mapping.enable_loop_closure=False")


@dataclasses.dataclass
class MappingMeta(Container):
    """Everything in the mapping state EXCEPT the keyframe cloud blocks."""

    kf_pose: Tensor         # (K, 6) map-frame keyframe poses
    kf_stamp: Tensor        # (K,)
    kf_count: Tensor        # () int32
    grid: Any               # incremental submap of the loop-ON path: None
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
    #   voxels truncated by max_map_corner/max_map_surf in the radius-submap
    #   assembly.  Key-order truncation of a WORLD-frame aggregate censors
    #   the map at an x-plane (match/voxelhash.py) — nonzero means those
    #   capacities are undersized for the run.


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


def init_state(cfg: LegoLoamConfig, device: DeviceLike = None
               ) -> MappingState:
    device = resolve_device(device)
    m = cfg.mapping
    K = m.max_keyframes

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    meta = MappingMeta(
        kf_pose=f32(K, 6), kf_stamp=f32(K), kf_count=i32(),
        grid=None,
        graph=empty_graph(K + m.max_loop_factors, device),
        factor_count=i32(), cycle=i32(),
        aft_mapped=f32(6), bef_mapped=f32(6),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        kf_dropped=i32(), factor_dropped=i32(), map_sat=i32())
    return MappingState(meta=meta, clouds=empty_clouds(cfg, device))


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


def mapping_step(meta: MappingMeta, clouds: KeyframeClouds,
                 assoc: AssociationOut, cfg: LegoLoamConfig):
    """One mapping cycle (loop closure off).

    ``clouds`` is read-only; the (possibly dropped) inserted keyframe row
    comes back for the caller to ``apply_row``.  Returns
    (new_meta, KeyframeRow, mapped_pose (6,), loop_diag (8,) zeros).

    Apart from the thin-map gate and the convergence reads inside
    ``scan_to_map``, nothing here is read on the host: the keyframe /
    factor decisions are masked writes.
    """
    m = cfg.mapping
    if m.enable_loop_closure:
        raise NotImplementedError(_LOOP_MSG)
    dev = assoc.odom.device
    pred = predict_pose(meta, assoc.odom)

    # downsampleCurrentScan (:999-1026).  Exact sort-based centroids here:
    # these clouds become the PERSISTENT keyframe blocks (and scan-to-map
    # queries), where any loss compounds over the whole trajectory.
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

    # extractSurroundingKeyFrames (:857-996), loop-OFF mode (the
    # reference's default config): 50 m keypose RADIUS search (:917-986) —
    # a revisit must re-associate against the OLD map, which a latest-N
    # window cannot provide.  Assembled from the keyframe store each cycle.
    store0 = KeyframeStore(pose=meta.kf_pose, stamp=meta.kf_stamp,
                           count=meta.kf_count, clouds=clouds)
    corner_map, surf_map, submap_sat = assemble_submap(
        store0, pred, cfg,
        window=m.surrounding_keyframe_search_num, with_sat=True)
    map_sat = meta.map_sat + submap_sat.to(meta.map_sat.dtype)

    pose = scan_to_map(pred, corner_ds, corner_ok, surf_total,
                       surf_total_ok, corner_map, surf_map, cfg)
    pose = se3.normalize_angles(pose)

    # saveKeyFramesAndFactor (:1335-1478): keyframe iff moved ≥ 0.3 m
    K = clouds.capacity
    last_i = torch.clamp(meta.kf_count - 1, min=0)
    last_kf = take_row(meta.kf_pose, last_i)
    dp = pose[3:] - last_kf[3:]
    moved = torch.sqrt(torch.sum(dp * dp))
    is_kf = (~meta.initialized) | (moved >= m.keyframe_distance)
    insert = is_kf & (meta.kf_count < K)
    kf_dropped = meta.kf_dropped + (is_kf & ~insert).to(torch.int32)

    idx = torch.where(insert, meta.kf_count, K).to(torch.int32)  # K ⇒ dropped
    row = make_row(idx, corner_ds, corner_ok, surf_ds, surf_ok,
                   outlier_ds, outlier_ok, scan2d_ds, scan2d_ok)
    kf_pose = put_row(meta.kf_pose, idx, pose)
    kf_stamp = put_row(meta.kf_stamp, idx, assoc.stamp)
    kf_count = meta.kf_count + insert.to(torch.int32)

    # factors: PriorFactor on node 0 (:1363-1369) with the first keyframe,
    # BetweenFactor(prev, new) (:1384-1398) with every later one
    odom_w = torch.tensor(m.odom_factor_weight, dtype=torch.float32,
                          device=dev)
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

    new_meta = MappingMeta(
        kf_pose=kf_pose, kf_stamp=kf_stamp, kf_count=kf_count,
        grid=meta.grid, graph=graph, factor_count=fcount,
        cycle=meta.cycle + 1, aft_mapped=pose, bef_mapped=assoc.odom,
        initialized=torch.ones_like(meta.initialized),
        kf_dropped=kf_dropped, factor_dropped=fdrop, map_sat=map_sat)
    loop_diag = torch.zeros((8,), dtype=torch.float32, device=dev)
    return new_meta, row, pose, loop_diag

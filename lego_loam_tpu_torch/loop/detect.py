"""Loop-closure detection + verification.

Reimplements ``detectLoopClosure`` (``mapOptmization.cpp:696-764``) and the
geometric half of ``performLoopClosure`` (:767-854): candidate = nearest
keypose within ``history_keyframe_search_radius`` (7 m) that is at least
``loop_closure_time_gap`` older; target submap = candidate ±25 keyframes
(0.4 m downsampled); source = the latest keyframe's corner+surf cloud;
verification = ICP with ``fitness < history_keyframe_fitness_score`` (0.3)
plus the JAX package's correspondence floor and plausibility caps.

Returns everything the pose graph needs to add the loop factor:
(found, old index, measurement z = corrected_latest⁻¹ ∘ old, fitness).

The JAX package's ``lax.cond`` around the attempt is one counted host read
here ("is there a candidate"): the attempt (history gather, voxel filter,
ICP) is far too costly to run masked.
"""

from __future__ import annotations

import math

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..core.device import host_bool
from ..graph.keyframes import KeyframeRow, KeyframeStore, as_points, take_row
from ..match.voxelhash import voxel_downsample
from .icp import icp_align

Tensor = torch.Tensor


def find_candidate(store: KeyframeStore, cur_pose: Tensor,
                   cur_stamp: Tensor, cfg: LegoLoamConfig):
    """Nearest sufficiently-old keypose within the search radius.

    Returns (found () bool, index () int32)."""
    m = cfg.mapping
    K = store.capacity
    alive = torch.arange(K, device=store.pose.device) < store.count
    dp = store.pose[:, 3:] - cur_pose[3:]
    d = torch.sqrt(torch.sum(dp * dp, dim=-1))
    old_enough = (cur_stamp - store.stamp) > m.loop_closure_time_gap
    elig = alive & old_enough & (d < m.history_keyframe_search_radius)
    idx = torch.argmin(torch.where(elig, d, math.inf)).to(torch.int32)
    return torch.any(elig), idx


def _row_points(row: KeyframeRow):
    return (torch.cat([as_points(row.corner), as_points(row.surf)], dim=0),
            torch.cat([row.corner_valid, row.surf_valid], dim=0))


def _gather_history(store: KeyframeStore, row: KeyframeRow, center: Tensor,
                    cfg: LegoLoamConfig):
    """World-frame submap from keyframes center±history_keyframe_search_num
    (``detectLoopClosure``, :727-753), 0.4 m downsampled.

    ``row`` (the keyframe inserted THIS cycle, not yet written into the
    cloud blocks) substitutes for its index if the window overlaps it."""
    m = cfg.mapping
    half = m.history_keyframe_search_num
    ks = torch.arange(2 * half + 1, device=store.pose.device) - half + center
    ok = (ks >= 0) & (ks < store.count)
    ks = torch.clamp(ks, 0, store.capacity - 1).to(torch.int64)

    pose = store.pose[ks]                                   # (W, 6)
    pts = torch.cat([as_points(store.corner[ks]),
                     as_points(store.surf[ks])], dim=1)     # (W, C, 3)
    valid = torch.cat([store.corner_valid[ks], store.surf_valid[ks]], dim=1)
    if row is not None:
        use_row = (ks == row.idx)[:, None]
        row_pts, row_valid = _row_points(row)
        pts = torch.where(use_row[..., None], row_pts, pts)
        valid = torch.where(use_row, row_valid, valid)
    valid = valid & ok[:, None]
    world = torch.where(valid[..., None], se3.apply(pose[:, None, :], pts),
                        0.0)
    tgt, tgt_valid, n_vox = voxel_downsample(
        world.reshape(-1, 3), valid.reshape(-1),
        m.outlier_leaf_size, m.loop_history_cap, with_count=True)
    # world-frame aggregate: truncation censors at an x-plane — count it
    return tgt, tgt_valid, torch.clamp(n_vox - m.loop_history_cap, min=0)


def _gather_latest(store: KeyframeStore, row: KeyframeRow, idx: Tensor,
                   source_cap: int):
    """Latest keyframe's corner+surf cloud in world frame (:729-738).

    ``row`` is the keyframe inserted THIS mapping cycle, which is not yet
    written into the cloud blocks (see ``pipeline/mapping``): when it is the
    latest keyframe (idx == row.idx) its payload is used directly.

    VALID points are left-compacted before the ``source_cap`` cut: the raw
    [corner | surf] concatenation puts all surf slots last, so a blind
    truncation at small caps silently dropped the ENTIRE surf block and fed
    ICP a corner-only source (found in the JAX package as a diverged loop
    ICP with fitness ≈ 15 in a shrunken-config end-to-end test)."""
    pose = take_row(store.pose, idx)
    pts = torch.cat([as_points(take_row(store.corner, idx)),
                     as_points(take_row(store.surf, idx))], dim=0)
    valid = torch.cat([take_row(store.corner_valid, idx),
                       take_row(store.surf_valid, idx)], dim=0)
    if row is not None:
        use_row = idx == row.idx
        row_pts, row_valid = _row_points(row)
        pts = torch.where(use_row, row_pts, pts)
        valid = torch.where(use_row, row_valid, valid)
    world = torch.where(valid[:, None], se3.apply(pose, pts), 0.0)
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    dest = torch.where(valid & (rank < source_cap), rank, source_cap)
    out = torch.zeros((source_cap + 1, 3), dtype=world.dtype,
                      device=world.device)
    out = out.index_copy_(0, dest, world)[:source_cap]
    n = torch.clamp(torch.sum(valid), max=source_cap)
    return out, torch.arange(source_cap, device=world.device) < n


def detect_and_verify(store: KeyframeStore, row: KeyframeRow,
                      cur_stamp: Tensor, cfg: LegoLoamConfig,
                      robot_pose: Tensor = None):
    """Full loop-closure attempt for the latest keyframe.

    ``robot_pose`` is the CURRENT mapped pose used for the candidate radius
    gate (``detectLoopClosure`` searches around ``currentRobotPosPoint``,
    ``mapOptmization.cpp:705-708`` — which can be up to keyframe_distance
    ahead of the last keyframe); the ICP source / factor endpoints stay
    anchored at the latest keyframe.  Defaults to the latest keyframe pose.

    Returns dict(found, old_idx, latest_idx, z, fitness, corrected_pose,
    corr, implausible, sat) of tensors: ``z`` = measurement for the between
    factor (latest → old), ``corrected_pose`` = ICP-corrected world pose of
    the latest keyframe (``performLoopClosure``, :806-848), ``corr`` = the
    raw world-frame ICP correction (corrected_pose = corr ∘ latest pose —
    the quantity the plausibility gate thresholds), ``implausible`` = passed
    the fitness gate but failed the plausibility caps, ``sat`` = voxels the
    ``loop_history_cap`` cut truncated in the ICP target.
    """
    m = cfg.mapping
    dev = store.pose.device
    latest = torch.clamp(store.count - 1, min=0)
    cur_pose = take_row(store.pose, latest)
    gate_pose = cur_pose if robot_pose is None else robot_pose

    found, old_idx = find_candidate(store, gate_pose, cur_stamp, cfg)

    if host_bool(found):
        tgt, tgt_valid, hist_sat = _gather_history(store, row, old_idx, cfg)
        src, src_valid = _gather_latest(store, row, latest,
                                        m.loop_source_cap)
        corr, fitness, n_corr = icp_align(
            src, src_valid, tgt, tgt_valid, max_iters=m.icp_max_iters,
            max_corr_dist=m.icp_max_corr_dist, eps=m.icp_eps)
        # Correction-plausibility gate (config.py::
        # loop_max_correction_rot_deg): a closure whose ICP "correction"
        # rotates the frame by degrees is a false minimum regardless of
        # fitness.
        rot_ok = torch.max(torch.abs(corr[:3])) < math.radians(
            m.loop_max_correction_rot_deg)
        trans_ok = torch.sqrt(torch.sum(corr[3:] ** 2)) \
            < m.loop_max_correction_trans
        # DELIBERATE DEVIATION from the reference gate (converged ∧ fitness
        # < 0.3, mapOptmization.cpp:798-800), kept from the JAX package: the
        # n_corr floor stands in for PCL's hasConverged(), rejecting
        # near-disjoint alignments whose few inliers give a deceptively low
        # fitness.
        fit_ok = (fitness < m.history_keyframe_fitness_score) \
            & (n_corr > 100)
        ok = fit_ok & rot_ok & trans_ok
        implausible = fit_ok & ~(rot_ok & trans_ok)
        corrected = se3.compose(corr, cur_pose)
        z = se3.relative(corrected, take_row(store.pose, old_idx))
        sat = hist_sat.to(torch.int32)
    else:
        zeros6 = torch.zeros((6,), dtype=torch.float32, device=dev)
        ok = torch.zeros((), dtype=torch.bool, device=dev)
        implausible = ok
        z, corr, corrected = zeros6, zeros6, cur_pose
        fitness = torch.tensor(1e9, dtype=torch.float32, device=dev)
        sat = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "found": ok,
        "old_idx": old_idx,
        "latest_idx": latest.to(torch.int32),
        "z": z,
        "fitness": fitness,
        "corrected_pose": corrected,
        "corr": corr,
        "implausible": implausible,
        "sat": sat,
    }

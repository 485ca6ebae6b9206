"""Incremental world-frame submap as a persistent voxel hash grid.

The loop-closure-ON submap of the mapping stage (the reference's
``extractSurroundingKeyFrames`` latest-50 window,
``mapOptmization.cpp:863-913``): instead of re-concatenating and
re-downsampling ~50 keyframe clouds every mapping cycle, the submap lives in
the mapping state as two fixed-capacity voxel hash grids (corner /
surf+outlier).  Each slot holds a world-frame RUNNING CENTROID (coordinate
sum + count) and the index of the last keyframe that wrote it:

* **insert** (on keyframe creation only): scatter-add the new keyframe's
  downsampled points into their hashed voxel slots — the union voxel filter
  and the sliding-window eviction in one step;
* **read** (every mapping cycle, :func:`maps`): a slot is live iff its
  writer tag is among the latest ``surrounding_keyframe_search_num``
  keyframes; slots whose writers slid out of the window go stale with zero
  work;
* **rebuild** (loop closure only): ``correctPoses``
  (``mapOptmization.cpp:1481-1511``) rewrites every keyframe pose, so the
  grid is re-scattered from the window keyframes under their corrected
  poses.

Differences vs the reference, by design (those of the JAX package): a slot's
centroid accumulates over the voxel's whole in-window lifetime, and distinct
voxels may collide in the hash.

Port notes:

* The hash (:func:`_slots`) multiplies int32 voxel coordinates by 8-digit
  primes, which wraps in int32 for every real point.  Here it is computed in
  int64; the low 31 bits of products and XORs do not depend on the higher
  bits, so ``h & (2**31 - 1)`` equals the JAX package's int32 result bit for
  bit on any device.  The voxel coordinate is ``floor(xyz * (1/leaf))`` with
  the float32 reciprocal, as the JAX package's compiled code computes
  ``xyz / leaf`` (``match/voxelhash.py::recip32``).
* Which write wins a slot: :func:`rebuild` scatters the tags of up to
  ``window`` keyframes, and "the newest keyframe wins each voxel" is what
  :func:`insert` produces one keyframe at a time.  Neither XLA nor a CUDA
  ``index_put_`` promises an order for duplicate indices, so the tag is
  written with ``scatter_reduce(..., "amax")``: keyframe indices grow with
  time, so the largest tag is the newest writer, on every device.  (The JAX
  package's sequential CPU scatter writes surf blocks before outlier blocks,
  so there an outlier point of an OLDER keyframe can overwrite the tag a
  newer keyframe's surf point left; the tests count those slots.)
* The coordinate sums and counts are summed in an order fixed by the input
  (``core/segsum.py``), not with float atomics, so a card run repeats bit for
  bit; on the CPU they equal a sequential scatter-add's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device
from ..core.segsum import segment_sum, segments
from ..core.types import Container
from ..match.voxelhash import recip32
from ..solve.scan2map import MapCloud
from .keyframes import (CORNER_CAP, OUTLIER_CAP, SURF_CAP, KeyframeClouds,
                        as_points)

Tensor = torch.Tensor


@dataclasses.dataclass
class SubmapGrid(Container):
    """Two voxel hash grids of running centroids (see the module
    docstring); the JAX package's field names and shapes."""

    corner_sum: Tensor    # (Sc, 3) world-frame coordinate sums
    corner_cnt: Tensor    # (Sc,) float32 hit counts
    corner_tag: Tensor    # (Sc,) int32 last-writer keyframe index, -1=empty
    surf_sum: Tensor      # (Ss, 3)
    surf_cnt: Tensor      # (Ss,)
    surf_tag: Tensor      # (Ss,)


def empty_grid(cfg: LegoLoamConfig, device: DeviceLike = None) -> SubmapGrid:
    device = resolve_device(device)
    m = cfg.mapping

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def tags(n):
        return torch.full((n,), -1, dtype=torch.int32, device=device)

    return SubmapGrid(
        corner_sum=f32(m.max_map_corner, 3), corner_cnt=f32(m.max_map_corner),
        corner_tag=tags(m.max_map_corner),
        surf_sum=f32(m.max_map_surf, 3), surf_cnt=f32(m.max_map_surf),
        surf_tag=tags(m.max_map_surf))


def _slots(xyz: Tensor, valid: Tensor, leaf: float, n_slots: int) -> Tensor:
    """Spatial hash of each point's voxel cell into [0, n_slots); invalid
    points map to n_slots (a scratch slot that is thrown away)."""
    q = torch.floor(xyz * recip32(leaf)).to(torch.int32).to(torch.int64)
    h = (q[..., 0] * 73856093) ^ (q[..., 1] * 19349663) \
        ^ (q[..., 2] * 83492791)
    slot = torch.remainder(h & (2 ** 31 - 1), n_slots)
    return torch.where(valid, slot, n_slots)


def _scatter_add(grid_sum: Tensor, grid_cnt: Tensor, grid_tag: Tensor,
                 slot: Tensor, xyz: Tensor, valid: Tensor, tag: Tensor):
    """Accumulate points into slots; the newest writer (largest tag) re-tags
    a slot.  ``slot == n_slots`` drops the point.  Out of place."""
    n = grid_sum.shape[0]
    dev = grid_sum.device
    w = valid.to(grid_sum.dtype)
    # each slot's old value heads its run, so a run sums old + p1 + p2 + …
    seg = segments(torch.cat([torch.arange(n, device=dev), slot]), n)
    new_sum = segment_sum(torch.cat(
        [grid_sum, torch.where(valid[:, None], xyz, 0.0)]), seg)
    new_cnt = segment_sum(torch.cat([grid_cnt, w]), seg)
    tags = torch.broadcast_to(tag.to(torch.int32), slot.shape)
    new_tag = torch.cat([grid_tag, grid_tag.new_full((1,), -1)])
    new_tag = new_tag.scatter_reduce_(0, slot, tags, "amax",
                                      include_self=False)[:n]
    return new_sum, new_cnt, new_tag


def _zero_stale(grid: SubmapGrid, lo: Tensor) -> SubmapGrid:
    """Reset accumulators of slots whose writer fell out of the window, so a
    re-touched voxel restarts its centroid instead of mixing epochs."""
    c_stale = (grid.corner_tag < lo)[:, None]
    s_stale = (grid.surf_tag < lo)[:, None]
    return grid.replace(
        corner_sum=torch.where(c_stale, 0.0, grid.corner_sum),
        corner_cnt=torch.where(c_stale[:, 0], 0.0, grid.corner_cnt),
        surf_sum=torch.where(s_stale, 0.0, grid.surf_sum),
        surf_cnt=torch.where(s_stale[:, 0], 0.0, grid.surf_cnt))


def insert(grid: SubmapGrid, tag: Tensor, pose: Tensor,
           corner: Tensor, corner_valid: Tensor,
           surf: Tensor, surf_valid: Tensor,
           outlier: Tensor, outlier_valid: Tensor,
           cfg: LegoLoamConfig, window: int,
           enable: Tensor = None) -> SubmapGrid:
    """Accumulate one keyframe's sensor-frame clouds (already per-scan
    downsampled) into the grid under ``pose``; ``tag`` is the keyframe's
    index.  Surf and outlier clouds share the surf grid (the reference's
    surf-map = surf + outlier union, :992-994).

    ``enable`` (() bool, optional) masks the whole insert on the device: when
    False the grid comes back unchanged, with no host read (the JAX package
    wraps the call in a ``lax.cond``)."""
    m = cfg.mapping
    tag = torch.as_tensor(tag, dtype=torch.int32, device=pose.device)
    lo = tag - window + 1
    if enable is not None:
        lo = torch.where(enable, lo, -1)         # no tag is < -1
        corner_valid = corner_valid & enable
        surf_valid = surf_valid & enable
        outlier_valid = outlier_valid & enable
    grid = _zero_stale(grid, lo)
    cw = se3.apply(pose, corner)
    sw = se3.apply(pose, surf)
    ow = se3.apply(pose, outlier)

    c_slot = _slots(cw, corner_valid, m.corner_leaf_size, m.max_map_corner)
    corner_sum, corner_cnt, corner_tag = _scatter_add(
        grid.corner_sum, grid.corner_cnt, grid.corner_tag, c_slot, cw,
        corner_valid, tag)

    s_xyz = torch.cat([sw, ow], dim=0)
    s_ok = torch.cat([surf_valid, outlier_valid], dim=0)
    s_slot = _slots(s_xyz, s_ok, m.surf_leaf_size, m.max_map_surf)
    surf_sum, surf_cnt, surf_tag = _scatter_add(
        grid.surf_sum, grid.surf_cnt, grid.surf_tag, s_slot, s_xyz, s_ok,
        tag)

    return SubmapGrid(corner_sum=corner_sum, corner_cnt=corner_cnt,
                      corner_tag=corner_tag, surf_sum=surf_sum,
                      surf_cnt=surf_cnt, surf_tag=surf_tag)


def maps(grid: SubmapGrid, kf_count: Tensor, window: int):
    """The live submap view (voxel centroids): slots written by the latest
    ``window`` keyframes (the reference's latest-50 deque,
    ``mapOptmization.cpp:863-913``)."""
    lo = kf_count - window
    corner_ok = ((grid.corner_tag >= lo) & (grid.corner_tag >= 0)
                 & (grid.corner_cnt > 0))
    surf_ok = ((grid.surf_tag >= lo) & (grid.surf_tag >= 0)
               & (grid.surf_cnt > 0))
    corner_xyz = grid.corner_sum / torch.clamp(grid.corner_cnt,
                                               min=1.0)[:, None]
    surf_xyz = grid.surf_sum / torch.clamp(grid.surf_cnt, min=1.0)[:, None]
    return (MapCloud(xyz=torch.where(corner_ok[:, None], corner_xyz, 0.0),
                     valid=corner_ok),
            MapCloud(xyz=torch.where(surf_ok[:, None], surf_xyz, 0.0),
                     valid=surf_ok))


def rebuild(kf_pose: Tensor, kf_count: Tensor, clouds: KeyframeClouds,
            cfg: LegoLoamConfig, window: int) -> SubmapGrid:
    """Re-scatter the window keyframes from scratch — after a loop closure
    rewrote the keyframe poses (``correctPoses``,
    ``mapOptmization.cpp:1481-1511``; the reference clears its
    transformed-cloud cache there, :1497).  The newest keyframe wins each
    voxel's tag, as with :func:`insert` one keyframe at a time."""
    K = clouds.capacity
    dev = kf_pose.device
    sel = torch.arange(window, dtype=torch.int32, device=dev) \
        + (kf_count - window)
    in_range = (sel >= 0) & (sel < kf_count)
    sel_c = torch.clamp(sel, 0, K - 1).to(torch.int64)

    pose = kf_pose[sel_c]                                    # (W, 6)
    tag = torch.where(in_range, sel_c.to(torch.int32), -1)

    def world(block, valid_block):
        pts = as_points(block[sel_c])                        # (W, C, 3)
        ok = valid_block[sel_c] & in_range[:, None]
        w = se3.apply(pose[:, None, :], pts)
        return (torch.where(ok[:, :, None], w, 0.0).reshape(-1, 3),
                ok.reshape(-1))

    m = cfg.mapping
    cw, c_ok = world(clouds.corner, clouds.corner_valid)
    sw, s_ok = world(clouds.surf, clouds.surf_valid)
    ow, o_ok = world(clouds.outlier, clouds.outlier_valid)
    tag_c = torch.repeat_interleave(tag, CORNER_CAP)
    tag_s = torch.cat([torch.repeat_interleave(tag, SURF_CAP),
                       torch.repeat_interleave(tag, OUTLIER_CAP)])

    empty = empty_grid(cfg, dev)
    c_slot = _slots(cw, c_ok, m.corner_leaf_size, m.max_map_corner)
    corner_sum, corner_cnt, corner_tag = _scatter_add(
        empty.corner_sum, empty.corner_cnt, empty.corner_tag,
        c_slot, cw, c_ok, tag_c)

    s_xyz = torch.cat([sw, ow], dim=0)
    s_all_ok = torch.cat([s_ok, o_ok], dim=0)
    s_slot = _slots(s_xyz, s_all_ok, m.surf_leaf_size, m.max_map_surf)
    surf_sum, surf_cnt, surf_tag = _scatter_add(
        empty.surf_sum, empty.surf_cnt, empty.surf_tag,
        s_slot, s_xyz, s_all_ok, tag_s)

    return SubmapGrid(corner_sum=corner_sum, corner_cnt=corner_cnt,
                      corner_tag=corner_tag, surf_sum=surf_sum,
                      surf_cnt=surf_cnt, surf_tag=surf_tag)

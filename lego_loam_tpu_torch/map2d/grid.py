"""2D log-odds occupancy grid — the ``szyh_slam`` subsystem.

The reference accumulates keyframe-synchronized 2D virtual scans and
ray-traces them into a probability grid with Bresenham
(``probability_grid_map.cpp:36-53``), log-odds free −2 / occupied +3,
clamped to [0, 100], unknown 50, at 0.05 m resolution
(``probability_grid_map.h:17-23``, ``mapOptmization.cpp:602``).

As in the JAX package, each ray is sampled at one-cell granularity
(vectorized DDA) and all cell updates land in two scatter-adds;
consecutive-duplicate cells along a ray are masked so a cell is decremented
at most once per ray.  The updates are integers, so the grid is exact
whatever order a device applies them in.

Port notes: cell coordinates multiply by the float32 reciprocal of the
resolution, as the JAX package's compiled code does, so the cells are the
same (``match/voxelhash.py::recip32``).  The grid is built when artifacts
are written, not on the replay path.  The valid rays are gathered first (one
host read) and traced in chunks, so the (rays × ``max_ray_steps``) sample
array never exists whole.
"""

from __future__ import annotations

import math

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..graph.keyframes import KeyframeStore, as_points, take_rows
from ..match.voxelhash import recip32

Tensor = torch.Tensor

_RAY_CHUNK = 8192        # rays traced at once


def world_to_cell(xy: Tensor, origin: Tensor, resolution: float) -> Tensor:
    """(…,2) world coords → (…,2) int32 cell indices."""
    return torch.floor((xy - origin) * recip32(resolution)).to(torch.int32)


def _ray_cells(o_xy: Tensor, p_xy: Tensor, origin: Tensor,
               cfg: LegoLoamConfig):
    """Cells traversed from origin to endpoint (exclusive), one per step,
    for a batch of rays (R, 2).

    Returns (cells (R,T,2) int32, valid (R,T)) with duplicates masked.
    """
    g = cfg.grid2d
    T = g.max_ray_steps
    dev = o_xy.device
    d = p_xy - o_xy
    dist = torch.sqrt(torch.sum(d * d, dim=-1))                  # (R,)
    cells_len = dist * recip32(g.resolution)
    n_steps = torch.clamp(torch.floor(cells_len).to(torch.int32), max=T)
    steps = torch.arange(T, dtype=torch.float32, device=dev)
    t = (steps + 0.5)[None, :] / torch.clamp(cells_len, min=1e-6)[:, None]
    pts = o_xy[:, None, :] + torch.clamp(t, 0.0, 1.0)[..., None] \
        * d[:, None, :]
    cells = world_to_cell(pts, origin, g.resolution)
    step_ok = torch.arange(T, device=dev)[None, :] < n_steps[:, None]
    # mask consecutive duplicates (visit-once along the ray)
    same = torch.cat([
        torch.zeros((cells.shape[0], 1), dtype=torch.bool, device=dev),
        torch.all(cells[:, 1:] == cells[:, :-1], dim=-1)], dim=1)
    return cells, step_ok & ~same


def rasterize_scans(points_w: Tensor, points_valid: Tensor,
                    origins_w: Tensor, origin: Tensor,
                    cfg: LegoLoamConfig) -> Tensor:
    """Accumulate rays into a log-odds grid.

    Args:
      points_w: (R, 3) world-frame scan endpoints (z ignored).
      points_valid: (R,)
      origins_w: (R, 3) per-ray sensor origin (world).
      origin: (2,) world coords of grid cell (0, 0).

    Returns (C, C) int32 grid in [clamp_min, clamp_max], unknown=50.
    """
    g = cfg.grid2d
    C = g.max_cells
    dev = points_w.device
    drop = C * C                                  # scratch cell
    delta = torch.zeros((C * C + 1,), dtype=torch.int32, device=dev)
    rays = torch.nonzero(points_valid)[:, 0]

    def inside(cells):
        return ((cells[..., 0] >= 0) & (cells[..., 0] < C)
                & (cells[..., 1] >= 0) & (cells[..., 1] < C))

    for lo in range(0, rays.shape[0], _RAY_CHUNK):
        r = rays[lo:lo + _RAY_CHUNK]
        p = points_w[r, :2]
        cells, cell_ok = _ray_cells(origins_w[r, :2], p, origin, cfg)
        flat = torch.where(cell_ok & inside(cells),
                           cells[..., 1] * C + cells[..., 0], drop)
        delta.index_add_(0, flat.reshape(-1).to(torch.int64),
                         torch.full((flat.numel(),), g.log_odds_free,
                                    dtype=torch.int32, device=dev))
        end = world_to_cell(p, origin, g.resolution)
        end_flat = torch.where(inside(end), end[:, 1] * C + end[:, 0], drop)
        delta.index_add_(0, end_flat.to(torch.int64),
                         torch.full((end_flat.numel(),),
                                    g.log_odds_occupied - g.log_odds_free,
                                    dtype=torch.int32, device=dev))
    # endpoint cell: the free pass may also have hit it; the reference
    # applies free along the ray then occupied at the end — the
    # approximation is one log-odds quantum (the JAX package's, kept).
    grid = torch.clamp(g.unknown + delta[:drop], g.clamp_min, g.clamp_max)
    return grid.reshape(C, C)


def build_occupancy_grid(store: KeyframeStore, center: Tensor,
                         cfg: LegoLoamConfig, max_frames: int = 256,
                         origin: Tensor = None):
    """Grid from keyframes around ``center`` (the reference rebuilds from
    keyposes within the visualization radius, ``publishProbabilityGridMap``,
    ``mapOptmization.cpp:599-630``).

    Frame selection reproduces the reference's 1 m keypose voxel downsample
    (``publishGlobalMap`` :633-693): ONE representative keyframe (the
    newest) per 1 m pose cell, then the ``max_frames`` nearest
    representatives.  As in the JAX package, the distance is taken to
    ``center[:2]``; ``eval/artifacts.py`` passes the mean keyframe POSE
    there, whose first two entries are roll and pitch (≈ 0), so in effect
    the distance from the world origin, against a 500 m radius.

    ``origin``: world coords of grid cell (0, 0); defaults to centring the
    ``max_cells`` square on ``center[:2]``.

    Returns (grid (C, C) int32, origin (2,)).
    """
    g = cfg.grid2d
    K = store.capacity
    dev = store.pose.device
    alive = torch.arange(K, device=dev) < store.count
    dxy = store.pose[:, 3:5] - center[None, :2]
    d = torch.sqrt(torch.sum(dxy * dxy, dim=-1))
    elig = alive & (d <= cfg.mapping.global_map_visualization_search_radius)

    leaf = cfg.mapping.surrounding_pose_leaf_size
    q = torch.floor(store.pose[:, 3:5] * recip32(leaf)).to(torch.int32) \
        .to(torch.int64)
    h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663)   # int32 wrap: low bits
    S = 4 * max_frames
    slot = torch.where(elig, torch.remainder(h & (2 ** 31 - 1), S), S)
    rep = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
    rep = rep.scatter_reduce_(0, slot, torch.arange(K, device=dev), "amax")
    rep = rep[:S]
    rep_ok = rep >= 0
    rep_c = torch.clamp(rep, 0, K - 1)
    d_rep = torch.where(rep_ok, d[rep_c], math.inf)
    # the max_frames nearest; equal distances keep the lower slot first
    d_sel, rsel = torch.sort(d_rep, stable=True)
    d_sel, rsel = d_sel[:max_frames], rsel[:max_frames]
    sel = rep_c[rsel]
    sel_ok = torch.isfinite(d_sel)

    if origin is None:
        origin = center[:2] - 0.5 * g.max_cells * g.resolution

    poses = store.pose[sel]                              # (F, 6)
    pts = as_points(take_rows(store.scan2d, sel))        # (F, S, 3)
    valid = take_rows(store.scan2d_valid, sel) & sel_ok[:, None]
    world = se3.apply(poses[:, None, :], pts)            # (F, S, 3)
    origins = poses[:, None, 3:6].expand(world.shape)

    grid = rasterize_scans(world.reshape(-1, 3), valid.reshape(-1),
                           origins.reshape(-1, 3), origin, cfg)
    return grid, origin

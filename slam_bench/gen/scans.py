"""Motion-distorted sweeps of a spinning LiDAR, raycast on the device.

The arithmetic of ``lego_loam_tpu_torch/io/synthetic.py::simulate_scan``
(columns fire in turn over the scan period, each column's beams share the
sensor pose at its firing time, points come out in the sensor frame at
firing time, in firing order, NaN rows for misses) and of its ``_raycast``
(ground plane, yaw-rotated boxes by the slab method, vertical cylinders),
rewritten in PyTorch float64 and batched over many scans at once, so that a
lap of scans takes a fraction of a second on the card instead of minutes on
one host core.  Trigonometry of the world and of the beams is done on the
host in NumPy, as the original does it; the range noise is drawn from a
``torch.Generator`` on the device.

``slam_bench/tests/test_slam_bench_gen.py`` holds the noise-free sweeps equal
to the original's within float64 rounding.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .world import Circle, World

_MAX_RANGE = 100.0
_RAYS_PER_CHUNK = 1 << 19


def image_size(laser: Dict) -> tuple:
    return int(laser["num_vertical_scans"]), int(laser["num_horizontal_scans"])


def beam_dirs(laser: Dict) -> np.ndarray:
    """(H, V, 3) unit beam directions in the sensor frame, float64: azimuth
    nudged 0.37 of a column and elevation 0.23 of a ring off the projection
    bins, as the original does."""
    V, H = image_size(laser)
    ang_res_x = 2.0 * math.pi / H
    ang_res_y = math.radians(laser["vertical_angle_top_deg"]
                             - laser["vertical_angle_bottom_deg"]) / max(V - 1, 1)
    k = np.arange(H)
    az = -(0.37 * ang_res_x + 2.0 * np.pi * k / H)
    v_ang = (np.radians(laser["vertical_angle_bottom_deg"])
             + (np.arange(V) + 0.23) * ang_res_y)
    cos_v = np.cos(v_ang)[None, :]
    return np.stack([
        np.cos(az)[:, None] * cos_v,
        np.sin(az)[:, None] * cos_v,
        np.broadcast_to(np.sin(v_ang)[None, :], (H, V)),
    ], axis=-1)


def _raycast(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor,
             box_cs: torch.Tensor, cyl: torch.Tensor) -> torch.Tensor:
    """Nearest-hit distance of rays o, d (R, 3) against the world; +inf for
    a miss or a hit beyond 100 m."""
    inf = torch.tensor(math.inf, dtype=o.dtype, device=o.device)
    dz = d[:, 2]
    tg = -o[:, 2] / dz
    t_best = torch.where((dz < -1e-9) & (tg > 1e-6), tg, inf)

    # boxes, in each box's frame: (R, B)
    cx, cy, hw, hd, h = (boxes[:, i] for i in range(5))
    c, s = box_cs[:, 0], box_cs[:, 1]
    rx = o[:, 0:1] - cx
    ry = o[:, 1:2] - cy
    ob = (c * rx + s * ry, -s * rx + c * ry, o[:, 2:3].expand_as(rx))
    db = (c * d[:, 0:1] + s * d[:, 1:2], -s * d[:, 0:1] + c * d[:, 1:2],
          d[:, 2:3].expand_as(rx))
    lo = (-hw, -hd, torch.zeros_like(h))
    hi = (hw, hd, h)
    tmin = tmax = None
    for a in range(3):
        inv = 1.0 / db[a]
        t1 = (lo[a] - ob[a]) * inv
        t2 = (hi[a] - ob[a]) * inv
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        # NaN (0 * inf) is ignored, as NumPy's nanmax / nanmin do
        tmin = near if tmin is None else torch.fmax(tmin, near)
        tmax = far if tmax is None else torch.fmin(tmax, far)
    hit = (tmax >= tmin) & (tmax > 1e-6)
    t_hit = torch.where(tmin > 1e-6, tmin, tmax)
    t_box = torch.where(hit, t_hit, inf).amin(dim=1)
    t_best = torch.minimum(t_best, t_box)

    # vertical cylinders: (R, C)
    ox = o[:, 0:1] - cyl[:, 0]
    oy = o[:, 1:2] - cyl[:, 1]
    dx, dy = d[:, 0:1], d[:, 1:2]
    a2 = dx ** 2 + dy ** 2
    bq = 2.0 * (ox * dx + oy * dy)
    cq = ox ** 2 + oy ** 2 - cyl[:, 2] ** 2
    disc = bq ** 2 - 4 * a2 * cq
    t1 = (-bq - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a2)
    z_hit = o[:, 2:3] + t1 * d[:, 2:3]
    hit = ((disc > 0) & (a2 > 1e-12) & (t1 > 1e-6) & (z_hit >= 0)
           & (z_hit <= cyl[:, 3]))
    t_cyl = torch.where(hit, t1, inf).amin(dim=1)
    t_best = torch.minimum(t_best, t_cyl)
    return torch.where(t_best > _MAX_RANGE, inf, t_best)


class Sweeps:
    """Ranges of one lap of ``circle`` through ``world``, raycast once, and
    the noised sweeps made from them.

    ``ranges``: (L, H, V) float64 on ``device``, scan i of the lap starting
    at ``i * period``.  The circle closes after exactly L periods, so lap k's
    sweeps see what lap 0's see; only the range noise differs."""

    def __init__(self, laser: Dict, circle: Circle, world: World,
                 device: torch.device):
        self.laser = laser
        self.circle = circle
        self.device = device
        V, H = image_size(laser)
        f64 = torch.float64
        self.dirs = torch.as_tensor(beam_dirs(laser), dtype=f64,
                                    device=device)                  # (H, V, 3)
        boxes = torch.as_tensor(world.boxes, dtype=f64, device=device)
        box_cs = torch.as_tensor(
            np.stack([np.cos(world.boxes[:, 5]), np.sin(world.boxes[:, 5])], 1),
            dtype=f64, device=device)
        cyl = torch.as_tensor(world.cylinders, dtype=f64, device=device)
        L = circle.scans_per_lap
        period = float(laser["scan_period"])
        k = np.arange(H)
        per_chunk = max(1, _RAYS_PER_CHUNK // (H * V))
        out = []
        for first in range(0, L, per_chunk):
            idx = np.arange(first, min(L, first + per_chunk))
            t_fire = idx[:, None] * period + period * k[None, :] / H  # (B, H)
            poses = circle.pose_at(t_fire)                            # (B, H, 6)
            yaw = poses[..., 2]
            rot = np.zeros(yaw.shape + (3, 3))
            rot[..., 0, 0] = np.cos(yaw)
            rot[..., 0, 1] = -np.sin(yaw)
            rot[..., 1, 0] = np.sin(yaw)
            rot[..., 1, 1] = np.cos(yaw)
            rot[..., 2, 2] = 1.0
            R = torch.as_tensor(rot, dtype=f64, device=device)
            org = torch.as_tensor(poses[..., 3:], dtype=f64, device=device)
            dw = torch.einsum("bhij,hvj->bhvi", R, self.dirs)       # (B,H,V,3)
            ow = org[:, :, None, :].expand_as(dw)
            t = _raycast(ow.reshape(-1, 3), dw.reshape(-1, 3), boxes, box_cs,
                         cyl)
            out.append(t.reshape(len(idx), H, V))
        self.ranges = torch.cat(out)                                  # (L, H, V)

    def points(self, noise_m: float, generator: torch.Generator,
               scans: slice = slice(None)) -> torch.Tensor:
        """(n, H*V, 3) float32 sweeps in firing order, NaN rows (or inf) for
        misses: the lap's ranges ``[scans]`` plus N(0, noise_m) drawn from
        ``generator``."""
        t = self.ranges[scans]
        if noise_m > 0.0:
            t = t + noise_m * torch.randn(t.shape, dtype=t.dtype,
                                          device=t.device, generator=generator)
        pts = self.dirs[None] * t[..., None]                          # (n,H,V,3)
        return pts.reshape(t.shape[0], -1, 3).to(torch.float32)


def pack(points: torch.Tensor, capacity: int):
    """``io.npz_io.pack_sequence``'s layout of (n, P, 3) sweeps: (n,
    capacity*3) float32 with non-finite rows zeroed, (n, capacity) bool
    valid; rows past P are padding."""
    n, P, _ = points.shape
    if P > capacity:
        raise ValueError(f"{P} points a sweep over the capacity {capacity}")
    finite = torch.isfinite(points).all(dim=-1)
    xyz = torch.zeros((n, capacity, 3), dtype=torch.float32,
                      device=points.device)
    xyz[:, :P] = torch.where(finite[..., None], points, 0.0)
    valid = torch.zeros((n, capacity), dtype=torch.bool, device=points.device)
    valid[:, :P] = finite
    return xyz.reshape(n, capacity * 3), valid

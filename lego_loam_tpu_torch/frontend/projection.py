"""Stage 1a — range-image projection, ground extraction, 2D virtual scan.

Reimplementation of the reference's ImageProjection steps 1-4
(``imageProjection.cpp:153-346``): the per-point loop becomes one vectorized
scatter-min; the column-major ground double loop becomes shifted-array
algebra over the (V, H) image.

Everything is fixed-shape: the unordered input cloud lives in a
``(P, 3)`` tensor with a validity mask, the image set in ``(V, H)`` tensors.
"""

from __future__ import annotations

import math

import torch

from ..core.config import LegoLoamConfig
from ..core.types import RangeImage, RawScan
from ..match.voxelhash import recip32

Tensor = torch.Tensor


def _norm3(x: Tensor) -> Tensor:
    """‖x‖ over the last axis as sqrt(x²+y²+z²), summed in that order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _start_end_orientation(raw: RawScan):
    """Scan start/end azimuth from the first/last valid raw point
    (``findStartEndAngle``, ``imageProjection.cpp:234-249``)."""
    P = raw.xyz.shape[0]
    v = raw.valid.to(torch.int8)
    first = torch.argmax(v).view(1)                  # first True (0 if none)
    last = (P - 1 - torch.argmax(v.flip(0))).view(1)
    p0 = raw.xyz.index_select(0, first)[0]
    p1 = raw.xyz.index_select(0, last)[0]
    start = -torch.arctan2(p0[1], p0[0])
    end = -torch.arctan2(p1[1], p1[0]) + 2.0 * math.pi
    diff = end - start
    end = torch.where(diff > 3.0 * math.pi, end - 2.0 * math.pi,
                      torch.where(diff < math.pi, end + 2.0 * math.pi, end))
    return start, end


def project_scan(raw: RawScan, cfg: LegoLoamConfig) -> RangeImage:
    """Project an unordered sweep into the (V, H) range-image set.

    Replaces ``projectPointCloud`` + ``groundRemoval``
    (``imageProjection.cpp:178-346``).  Duplicate hits on a pixel resolve
    deterministically to the closest point (min range, then min point id) —
    the reference's last-write-wins is nondeterministic under reordering,
    ours is not.
    """
    laser = cfg.laser
    V, H = laser.image_size
    xyz = raw.xyz
    P = xyz.shape[0]
    dev = xyz.device

    rng = _norm3(xyz)
    vertical = torch.arcsin(torch.clamp(
        xyz[:, 2] / torch.clamp(rng, min=1e-12), -1.0, 1.0))
    # the pitches are constants: multiply by their float32 reciprocals, as
    # the JAX package's compiled code does, so that a point on a row or
    # column edge lands in the same pixel
    row = torch.floor((vertical + laser.ang_bottom) * recip32(laser.ang_res_y)
                      ).to(torch.int32)
    horizon = torch.arctan2(xyz[:, 0], xyz[:, 1])
    col = (-torch.round((horizon - 0.5 * math.pi) * recip32(laser.ang_res_x))
           ).to(torch.int32) + H // 2
    col = torch.where(col >= H, col - H, col)

    ok = (raw.valid & (row >= 0) & (row < V) & (col >= 0) & (col < H)
          & (rng >= laser.min_range) & torch.isfinite(rng))
    flat = torch.where(ok, row * H + col, V * H)        # V*H ⇒ scratch slot

    # ONE scatter-min resolves the winner per pixel: the key packs
    # (quantized range, point id) so min-key == (min range, then min id).
    # An integer min is order-independent, so the winner is deterministic
    # whatever order the device applies the updates in.
    pid_bits = max(15, (P - 1).bit_length())
    rng_bits = 31 - pid_bits                 # 16 bits ⇒ 2 mm steps to 131 m
    scale = (2 ** rng_bits - 1) / 131.072
    q = torch.clamp((rng * scale).to(torch.int32), 0, 2 ** rng_bits - 1)
    sentinel = 2 ** 31 - 1
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    key = torch.where(ok, (q << pid_bits) | pid, sentinel)
    # out-of-image points land in a scratch slot past the image
    key_img = torch.full((V * H + 1,), sentinel, dtype=torch.int32,
                         device=dev)
    key_img.scatter_reduce_(0, flat.to(torch.int64), key, "amin")
    key_img = key_img[:V * H]

    valid_img = key_img != sentinel
    pid_img = key_img & (2 ** pid_bits - 1)
    xyz_img = torch.where(
        valid_img[:, None],
        xyz[torch.clamp(pid_img, 0, P - 1).to(torch.int64)], 0.0)
    # exact range of the winning point (recomputed, not dequantized)
    rng_img = torch.where(valid_img, _norm3(xyz_img), math.inf)

    rng_img = rng_img.reshape(V, H)
    valid_img = valid_img.reshape(V, H)
    xyz_img = xyz_img.reshape(V, H, 3)

    ground = _ground_mask(xyz_img, valid_img, cfg)
    start, end = _start_end_orientation(raw)

    return RangeImage(
        rng=rng_img, xyz=xyz_img, valid=valid_img, ground=ground,
        label=torch.full((V, H), -1, dtype=torch.int32, device=dev),
        start_orientation=start, end_orientation=end)


def _ground_mask(xyz_img: Tensor, valid_img: Tensor,
                 cfg: LegoLoamConfig) -> Tensor:
    """Vertically-adjacent-pixel ground test (``groundRemoval``,
    ``imageProjection.cpp:254-287``).

    Keeps the reference's quirk of using the FULL 3-D norm (incl. dZ) in the
    atan2 denominator (commented as a known bug at :278) — it is
    load-bearing for which points count as ground.
    """
    laser = cfg.laser
    proj = cfg.projection
    V, H = laser.image_size
    G = laser.ground_scan_index

    lower = xyz_img[:G]                     # rows 0..G-1
    upper = xyz_img[1:G + 1]                # rows 1..G
    d = upper - lower
    norm3 = _norm3(d)
    angle = torch.arctan2(d[..., 2], norm3)
    mount = math.radians(laser.sensor_mount_angle_deg)
    thresh = math.radians(proj.ground_angle_threshold_deg)
    pair_ground = (valid_img[:G] & valid_img[1:G + 1]
                   & ((angle - mount) <= thresh))

    ground = torch.zeros((V, H), dtype=torch.bool, device=xyz_img.device)
    ground[:G] = pair_ground
    ground[1:G + 1] |= pair_ground
    return ground


def virtual_scan_2d(img: RangeImage, cfg: LegoLoamConfig):
    """Fork addition: per-column min-range non-ground point at chest height
    (``imageProjection.cpp:311-330``) → the 2D occupancy-grid input.

    Returns ``(xyz (H,3), valid (H,))``.
    """
    p = cfg.projection
    z = img.xyz[..., 2]
    ok = (img.valid & ~img.ground
          & (z > p.virtual_scan_z_min) & (z < p.virtual_scan_z_max)
          & (img.rng < p.virtual_scan_max_range))
    r = torch.where(ok, img.rng, math.inf)
    win = torch.argmin(r, dim=0)                          # (H,)
    any_ok = torch.any(ok, dim=0)
    H = z.shape[1]
    xyz = img.xyz[win, torch.arange(H, device=z.device)]
    return torch.where(any_ok[:, None], xyz, 0.0), any_ok

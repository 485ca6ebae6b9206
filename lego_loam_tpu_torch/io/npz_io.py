"""Host-side scan containers: ``.npz`` sequence storage and packing of
point lists into fixed-capacity tensors.

Replaces the reference's rosbag replay input path (``main.cpp:59-95``):
sequences live as ``.npz`` archives of per-scan point arrays + ground truth
(the JAX package's layout), and are packed with NumPy into fixed-capacity
arrays and moved to the device in one copy.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device
from ..core.types import RawScan


def _warn_truncated(n_pts: int, capacity: int, where: str):
    """Capacity overflow is a silent point drop — make it loud.

    ``PipelineConfig.max_points`` is sized to the nominal grid (16×1800
    for VLP-16) with zero headroom; real clouds can slightly exceed it
    (dual-return modes, azimuth jitter), and the excess rows would
    otherwise vanish without signal."""
    warnings.warn(
        f"{where}: scan has {n_pts} points > capacity {capacity}; "
        f"{n_pts - capacity} dropped (raise PipelineConfig.max_points)",
        RuntimeWarning, stacklevel=3)


def pack_raw_scan(points: np.ndarray, stamp: float, capacity: int,
                  device: DeviceLike = None) -> RawScan:
    """(P,3) float array (NaN/inf rows = invalid) → fixed-capacity RawScan."""
    device = resolve_device(device)
    pts = np.asarray(points, np.float32)
    finite = np.isfinite(pts).all(axis=-1)
    if pts.shape[0] > capacity:
        _warn_truncated(pts.shape[0], capacity, "pack_raw_scan")
    n = min(pts.shape[0], capacity)
    xyz = np.zeros((capacity, 3), np.float32)
    valid = np.zeros((capacity,), bool)
    xyz[:n] = np.nan_to_num(pts[:n], nan=0.0, posinf=0.0, neginf=0.0)
    valid[:n] = finite[:n]
    return RawScan(xyz=torch.from_numpy(xyz).to(device),
                   valid=torch.from_numpy(valid).to(device),
                   stamp=torch.tensor(stamp, dtype=torch.float32,
                                      device=device))


def pack_sequence(scans: Sequence[np.ndarray], times: Sequence[float],
                  cfg: LegoLoamConfig, device: DeviceLike = None):
    """Stack a whole sequence into batched tensors — the layout ``replay``
    consumes.

    Returns (xyz (N, P*3), valid (N, P), times (N,)); the coordinate axis
    is flattened into the row, as in the JAX package, so the two replays
    take the same arrays.
    """
    device = resolve_device(device)
    cap = cfg.pipeline.max_points
    xyz = np.zeros((len(scans), cap, 3), np.float32)
    valid = np.zeros((len(scans), cap), bool)
    n_over = sum(1 for s in scans if np.asarray(s).shape[0] > cap)
    if n_over:
        worst = max(np.asarray(s).shape[0] for s in scans)
        _warn_truncated(worst, cap,
                        f"pack_sequence ({n_over}/{len(scans)} scans)")
    for i, pts in enumerate(scans):
        pts = np.asarray(pts, np.float32)
        finite = np.isfinite(pts).all(axis=-1)
        n = min(pts.shape[0], cap)
        xyz[i, :n] = np.nan_to_num(pts[:n], nan=0.0, posinf=0.0, neginf=0.0)
        valid[i, :n] = finite[:n]
    return (torch.from_numpy(xyz.reshape(len(scans), cap * 3)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(np.asarray(times, np.float32)).to(device))


def save_sequence(path: str, scans: Sequence[np.ndarray],
                  gt_poses: Optional[np.ndarray], times: Sequence[float]):
    """Write a sequence as the JAX package's ``.npz`` layout: one
    ``scan_<i>`` array per scan, ``times``, ``n_scans``, ``gt_poses``."""
    data = {f"scan_{i:06d}": s for i, s in enumerate(scans)}
    data["times"] = np.asarray(times, np.float32)
    data["n_scans"] = np.int64(len(scans))
    if gt_poses is not None:
        data["gt_poses"] = np.asarray(gt_poses, np.float32)
    np.savez_compressed(path, **data)


def load_sequence(path: str):
    """Read a sequence written by :func:`save_sequence` (or the JAX
    package's): returns (scans, gt_poses or None, times)."""
    with np.load(path) as z:
        n = int(z["n_scans"])
        scans = [z[f"scan_{i:06d}"] for i in range(n)]
        times = z["times"]
        gt = z["gt_poses"] if "gt_poses" in z else None
    return scans, gt, times

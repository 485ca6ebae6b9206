"""Observability artifacts — the reference's rviz topic set, as files.

The reference publishes ~20 debug topics (SURVEY.md §2.8: projected/
ground/segmented clouds, feature clouds, trajectory odometries, the
occupancy grid) plus a throughput log line (``main.cpp:84-93``).  Offline,
the equivalent is an artifact directory per run: trajectories in TUM
format (evo-compatible), point clouds as .npy, the 2D grid as PGM, and a
metrics JSON.  Same files and names as the JAX package's
``eval/artifacts.py``; the writers are its NumPy code, the map builders the
port's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..frontend.features import extract_features
from ..frontend.projection import project_scan
from ..frontend.segmentation import segment_cloud
from ..graph.keyframes import assemble_global_map
from ..map2d.grid import build_occupancy_grid


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """(N,3) roll/pitch/yaw → (N,4) qx qy qz qw (matches R = Rz Ry Rx)."""
    r, p, y = rpy[:, 0] / 2, rpy[:, 1] / 2, rpy[:, 2] / 2
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    qw = cr * cp * cy + sr * sp * sy
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    return np.stack([qx, qy, qz, qw], 1)


def write_tum_trajectory(path: str, poses: np.ndarray,
                         times: np.ndarray) -> None:
    """TUM format: ``t x y z qx qy qz qw`` — consumable by evo/rpg eval."""
    poses = np.asarray(poses)
    q = _rpy_to_quat(poses[:, :3])
    with open(path, "w") as f:
        for i in range(len(poses)):
            t = float(times[i])
            x, y, z = poses[i, 3:]
            f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{q[i,0]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} "
                    f"{q[i,3]:.6f}\n")


def write_occupancy_pgm(path: str, grid: np.ndarray) -> None:
    """Occupancy grid → binary PGM (0=occupied black, 254=free white,
    205=unknown — the map_server convention)."""
    g = np.asarray(grid)
    img = np.full(g.shape, 205, np.uint8)
    img[g < 50] = 254
    img[g > 50] = 0
    with open(path, "wb") as f:
        f.write(f"P5\n{g.shape[1]} {g.shape[0]}\n255\n".encode())
        f.write(img[::-1].tobytes())


def dump_map_artifacts(out_dir: str, state, cfg, suffix: str = "") -> None:
    """2D occupancy grid + global 3D map + keyframe poses — the
    reference's every-10th-cycle map publication
    (``publishGlobalMap``/``publishProbabilityGridMap``,
    ``mapOptmization.cpp:599-693, 1562-1568``).  ``suffix`` tags mid-run
    snapshots.  ``state`` is the port's ``SlamState`` on any device."""
    store = state.mapping.store
    count = int(store.count)
    if count == 0:
        return
    os.makedirs(out_dir, exist_ok=True)
    dev = store.pose.device
    poses = store.pose[:count].cpu().numpy()
    kf_xy = poses[:, 3:5]
    center = torch.from_numpy(poses.mean(0).astype(np.float32)).to(dev)
    # size the grid to the WHOLE trajectory bbox + sensor range
    margin = cfg.projection.virtual_scan_max_range + 2.0
    lo = kf_xy.min(0) - margin
    hi = kf_xy.max(0) + margin
    need = float((hi - lo).max()) / cfg.grid2d.resolution
    C = cfg.grid2d.max_cells
    while C < need and C < 16384:
        C *= 2                           # power-of-two size buckets
    cfg_g = cfg.replace(grid2d=dataclasses.replace(
        cfg.grid2d, max_cells=C))
    # center the (possibly larger) square on the bbox
    origin_xy = torch.from_numpy(np.asarray(
        0.5 * (lo + hi) - 0.5 * C * cfg.grid2d.resolution,
        np.float32)).to(dev)
    mf = 256                             # the JAX package's frame buckets
    while mf < min(1024, count):
        mf *= 2
    grid, origin = build_occupancy_grid(
        store, center, cfg_g, max_frames=mf, origin=origin_xy)
    write_occupancy_pgm(os.path.join(out_dir, f"map2d{suffix}.pgm"),
                        grid.cpu().numpy())
    np.save(os.path.join(out_dir, f"map2d_origin{suffix}.npy"),
            origin.cpu().numpy())
    np.save(os.path.join(out_dir, f"keyframe_poses{suffix}.npy"), poses)
    # /laser_cloud_surround: global 3D feature map
    # (publishGlobalMap, mapOptmization.cpp:633-693)
    gm_xyz, gm_ok = assemble_global_map(store, center, cfg)
    np.save(os.path.join(out_dir, f"global_map{suffix}.npy"),
            gm_xyz[gm_ok].cpu().numpy())


def dump_run_artifacts(out_dir: str, outputs: Dict[str, np.ndarray],
                       times: np.ndarray,
                       final_state=None,
                       cfg=None,
                       gt_poses: Optional[np.ndarray] = None,
                       metrics: Optional[dict] = None) -> None:
    """Write the full artifact set for one replay (``outputs``: NumPy
    arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(times)
    for name in ("odom", "fused", "mapped"):
        if name in outputs:
            write_tum_trajectory(
                os.path.join(out_dir, f"trajectory_{name}.tum"),
                np.asarray(outputs[name])[:n], times)
    if gt_poses is not None:
        write_tum_trajectory(os.path.join(out_dir, "trajectory_gt.tum"),
                             np.asarray(gt_poses)[:n], times)

    if final_state is not None and cfg is not None:
        dump_map_artifacts(out_dir, final_state, cfg)

    meta = {"n_scans": int(n), "written_at": time.time()}
    if metrics:
        meta.update(metrics)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(meta, f, indent=2)


def dump_scan_debug(out_dir: str, raw, cfg, index: int = 0) -> str:
    """Per-scan debug artifact — the reference's ImageProjection /
    FeatureAssociation rviz topics (``/full_cloud_projected``,
    ``/ground_cloud``, ``/segmented_cloud``, ``/outlier_cloud``,
    ``/laser_cloud_sharp`` … ``/laser_cloud_less_flat``) as one
    ``scan_debug_{index}.npz``.  ``raw`` is the port's
    :class:`~lego_loam_tpu_torch.core.types.RawScan` on any device."""
    img = project_scan(raw, cfg)
    proj = segment_cloud(img, raw.stamp, cfg)
    feats = extract_features(proj.segmented, cfg)

    def cloud(xyz, valid):
        return xyz.reshape(-1, 3)[valid.reshape(-1)].cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"scan_debug_{index}.npz")
    np.savez(
        path,
        range_image=img.rng.cpu().numpy(),
        ground_mask=img.ground.cpu().numpy(),
        full_cloud=cloud(img.xyz, img.valid),
        ground_cloud=cloud(img.xyz, img.valid & img.ground),
        segmented_cloud=cloud(proj.segmented.xyz, proj.segmented.valid),
        outlier_cloud=cloud(proj.outlier_xyz, proj.outlier_valid),
        virtual_scan_2d=cloud(proj.scan2d_xyz, proj.scan2d_valid),
        sharp=cloud(feats.sharp.xyz, feats.sharp.valid),
        less_sharp=cloud(feats.less_sharp.xyz, feats.less_sharp.valid),
        flat=cloud(feats.flat.xyz, feats.flat.valid),
        less_flat=cloud(feats.less_flat.xyz, feats.less_flat.valid))
    return path


class StageTimer:
    """Host-side per-stage wall-clock accumulator (the ``Processing the
    rosbag at X speed`` counter, ``main.cpp:84-93``, generalized)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, stage: str, seconds: float):
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4),
                "mean_ms": round(1000 * v / max(self.counts[k], 1), 3),
                "count": self.counts[k]}
            for k, v in self.totals.items()
        }

"""Trajectory evaluation: ATE / RPE.

The reference publishes no accuracy numbers (BASELINE.md); the judged
target is ATE ≤ reference on the benchmark sequences.  Standard
definitions: ATE = RMSE of translational error after SE(3) (Horn/Umeyama,
no scale) alignment; RPE = RMSE of per-Δ relative-pose translation error.
Pure NumPy (host-side evaluation).  The port's own copy of
the JAX package's ``eval/metrics.py``.
"""

from __future__ import annotations

import numpy as np


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    R = np.empty(rpy.shape[:-1] + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def poses_to_matrices(poses: np.ndarray) -> np.ndarray:
    """(N,6) [r,p,y,x,y,z] → (N,4,4)."""
    N = poses.shape[0]
    T = np.tile(np.eye(4), (N, 1, 1))
    T[:, :3, :3] = _rpy_to_matrix(poses[:, :3])
    T[:, :3, 3] = poses[:, 3:]
    return T


def align_se3(est_t: np.ndarray, gt_t: np.ndarray):
    """Horn alignment (rotation+translation, no scale) of estimated
    positions onto ground truth.  Returns (R, t)."""
    mu_e = est_t.mean(0)
    mu_g = gt_t.mean(0)
    H = (est_t - mu_e).T @ (gt_t - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate(est_poses: np.ndarray, gt_poses: np.ndarray,
        align: bool = True) -> dict:
    """Absolute trajectory error between (N,6) pose arrays."""
    est_t = np.asarray(est_poses)[:, 3:]
    gt_t = np.asarray(gt_poses)[:, 3:]
    if align:
        R, t = align_se3(est_t, gt_t)
        est_t = est_t @ R.T + t
    err = np.linalg.norm(est_t - gt_t, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
    }


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 10) -> dict:
    """Relative pose error over a frame delta."""
    Te = poses_to_matrices(np.asarray(est_poses))
    Tg = poses_to_matrices(np.asarray(gt_poses))
    errs_t, errs_r = [], []
    for i in range(len(Te) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        e = np.linalg.inv(dg) @ de
        errs_t.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        errs_r.append(np.degrees(np.arccos(cos)))
    return {
        "trans_rmse": float(np.sqrt(np.mean(np.square(errs_t)))),
        "rot_rmse_deg": float(np.sqrt(np.mean(np.square(errs_r)))),
    }

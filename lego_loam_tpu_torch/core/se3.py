"""SE(3) / SO(3) utilities — one clean convention for the whole engine.

* frame: lidar — x forward, y left, z up;
* pose vector ``p = [roll, pitch, yaw, tx, ty, tz]`` (radians, metres);
* rotation ``R(p) = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` (extrinsic x-y-z);
* a pose maps body/scan coordinates into the parent frame:
  ``x_parent = R x_body + t``.

Plain functions on tensors, shape-polymorphic over leading batch dims by
broadcasting.  The Gauss-Newton solvers need ∂R/∂(roll, pitch, yaw); it is
written out in closed form (:func:`rpy_to_matrix_jac`) instead of traced.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def rot_x(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, c, -s], -1),
        torch.stack([zero, s, c], -1),
    ], -2)


def rot_y(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([
        torch.stack([c, zero, s], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-s, zero, c], -1),
    ], -2)


def rot_z(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _drot_x(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    zero = torch.zeros_like(a)
    return torch.stack([
        torch.stack([zero, zero, zero], -1),
        torch.stack([zero, -s, -c], -1),
        torch.stack([zero, c, -s], -1),
    ], -2)


def _drot_y(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    zero = torch.zeros_like(a)
    return torch.stack([
        torch.stack([-s, zero, c], -1),
        torch.stack([zero, zero, zero], -1),
        torch.stack([-c, zero, -s], -1),
    ], -2)


def _drot_z(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    zero = torch.zeros_like(a)
    return torch.stack([
        torch.stack([-s, -c, zero], -1),
        torch.stack([c, -s, zero], -1),
        torch.stack([zero, zero, zero], -1),
    ], -2)


def rpy_to_matrix(rpy: Tensor) -> Tensor:
    """(…,3) [roll,pitch,yaw] → (…,3,3) with R = Rz Ry Rx."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)


def rpy_to_matrix_jac(rpy: Tensor) -> Tensor:
    """(…,3) → (…,3,3,3): ``out[..., k, :, :] = ∂R/∂rpy[k]``."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    Rx, Ry, Rz = rot_x(roll), rot_y(pitch), rot_z(yaw)
    return torch.stack([
        Rz @ Ry @ _drot_x(roll),
        Rz @ _drot_y(pitch) @ Rx,
        _drot_z(yaw) @ Ry @ Rx,
    ], -3)


def matrix_to_rpy(R: Tensor) -> Tensor:
    """(…,3,3) → (…,3) [roll,pitch,yaw]; inverse of :func:`rpy_to_matrix`.

    Gimbal-safe for |pitch| < π/2 (ground vehicles never approach it)."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1)


def pose_matrix(p: Tensor) -> Tensor:
    """(…,6) pose vector → (…,4,4) homogeneous transform."""
    R = rpy_to_matrix(p[..., :3])
    t = p[..., 3:]
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=p.dtype,
                          device=p.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def matrix_to_pose(T: Tensor) -> Tensor:
    """(…,4,4) → (…,6)."""
    return torch.cat([matrix_to_rpy(T[..., :3, :3]), T[..., :3, 3]], -1)


def _matvec(R: Tensor, v: Tensor) -> Tensor:
    return (R @ v[..., None])[..., 0]


def apply(p: Tensor, pts: Tensor) -> Tensor:
    """Transform points (…,3) by pose (…,6): ``R x + t``.

    Batch dims of pose and points broadcast (per-point poses supported —
    the de-skew path uses one interpolated pose per point)."""
    R = rpy_to_matrix(p[..., :3])
    return _matvec(R, pts) + p[..., 3:]


def apply_inverse(p: Tensor, pts: Tensor) -> Tensor:
    """``Rᵀ (x − t)``."""
    R = rpy_to_matrix(p[..., :3])
    return _matvec(R.transpose(-1, -2), pts - p[..., 3:])


def compose(a: Tensor, b: Tensor) -> Tensor:
    """Pose of ``b`` expressed through ``a``: ``T(a) @ T(b)`` as a 6-vector."""
    Ra = rpy_to_matrix(a[..., :3])
    Rb = rpy_to_matrix(b[..., :3])
    R = Ra @ Rb
    t = _matvec(Ra, b[..., 3:]) + a[..., 3:]
    return torch.cat([matrix_to_rpy(R), t], -1)


def inverse(p: Tensor) -> Tensor:
    R = rpy_to_matrix(p[..., :3])
    Rt = R.transpose(-1, -2)
    t = -_matvec(Rt, p[..., 3:])
    return torch.cat([matrix_to_rpy(Rt), t], -1)


def relative(a: Tensor, b: Tensor) -> Tensor:
    """``a⁻¹ ∘ b`` — the motion taking frame a to frame b."""
    return compose(inverse(a), b)


def scale_pose(p: Tensor, s: Tensor) -> Tensor:
    """Constant-velocity interpolation used for de-skew: linearly scale the
    Euler angles and translation (matches ``TransformToStart``,
    ``featureAssociation.cpp:388-418``, which does exactly this)."""
    return p * s


def normalize_angles(p: Tensor) -> Tensor:
    """Wrap the rpy part of a pose into (−π, π]."""
    ang = torch.remainder(p[..., :3] + math.pi, 2.0 * math.pi) - math.pi
    return torch.cat([ang, p[..., 3:]], -1)


def identity_pose(dtype=torch.float32, device=None) -> Tensor:
    return torch.zeros((6,), dtype=dtype, device=device)


# --- so(3)/se(3) exponential map (used by the pose-graph optimizer) --------

def skew(w: Tensor) -> Tensor:
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1),
    ], -2)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues formula, Taylor-safe near zero."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + 1e-32)
    K = skew(w)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: Tensor) -> Tensor:
    """Inverse of :func:`so3_exp` for θ < π, in atan2 form with an
    ε-regularised norm so derivatives stay finite at R = I."""
    w_hat = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)                                       # = 2 sinθ · axis
    s2 = torch.sqrt(torch.sum(w_hat * w_hat, -1) + 1e-24)   # 2 sinθ
    c2 = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0  # 2 cosθ
    theta = torch.arctan2(s2, c2)
    small = s2 < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.where(small, torch.ones_like(s2), s2))
    return scale[..., None] * w_hat

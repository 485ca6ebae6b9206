"""Closed-form small linear algebra — batched 3×3 ops without LAPACK.

The scan-to-map stage needs eigenvalues/eigenvectors of thousands of tiny
covariance matrices per association; the analytic forms (trigonometric
symmetric 3×3 eigenvalues, cross-product eigenvectors, Cramer solves) are
a handful of element-wise tensor ops each, where a batched LAPACK call
would iterate per matrix.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def solve3(A: Tensor, b: Tensor) -> Tensor:
    """Batched 3×3 solve via the adjugate.  A: (...,3,3), b: (...,3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-30,
                                torch.full_like(det, 1e-30), det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x0 = c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], -1) * inv_det[..., None]


def eigvals_sym3(A: Tensor) -> Tensor:
    """Eigenvalues of symmetric (...,3,3), ascending — the trigonometric
    (Smith) method, numerically safe for the near-degenerate covariance
    matrices line/plane tests produce."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)                          # largest
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)    # smallest
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], -1)


def principal_eigvec_sym3(A: Tensor, eigval: Tensor) -> Tensor:
    """Unit eigenvector of symmetric (...,3,3) for the given eigenvalue,
    via the column cross-product of (A − λI) (rank-2 ⇒ its null space is
    the eigendirection).  Picks the largest cross product of the three
    column pairs for stability (first of equals, as ``argmax`` does)."""
    M = A - eigval[..., None, None] * torch.eye(3, dtype=A.dtype,
                                                device=A.device)
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    v01 = torch.linalg.cross(c0, c1, dim=-1)
    v02 = torch.linalg.cross(c0, c2, dim=-1)
    v12 = torch.linalg.cross(c1, c2, dim=-1)
    n01 = torch.sum(v01 * v01, -1)
    n02 = torch.sum(v02 * v02, -1)
    n12 = torch.sum(v12 * v12, -1)
    best = torch.argmax(torch.stack([n01, n02, n12], -1), -1)
    cand = torch.stack([v01, v02, v12], -2)                  # (...,3,3)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    v = torch.gather(cand, -2, idx)[..., 0, :]
    norm = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    return v / torch.clamp(norm, min=1e-20)


def topk_small_min(d: Tensor, k: int):
    """Iterated masked argmin top-k (ascending) over the last axis; ties
    resolve to the lower index.

    Returns (values (...,k), indices (...,k) int32)."""
    vals, idxs = [], []
    cur = d
    n = d.shape[-1]
    ar = torch.arange(n, device=d.device)
    for _ in range(k):
        i = torch.argmin(cur, dim=-1)
        v = torch.gather(cur, -1, i[..., None])[..., 0]
        vals.append(v)
        idxs.append(i.to(torch.int32))
        cur = torch.where(ar == i[..., None],
                          torch.full_like(cur, 3e38), cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)

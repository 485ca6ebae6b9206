"""Point-to-point ICP — the PCL ICP replacement for loop closure.

The reference runs ``pcl::IterativeClosestPoint`` with maxCorrDist 100,
100 iterations, eps 1e-6, no RANSAC (``mapOptmization.cpp:785-796``) and
gates on ``getFitnessScore() < 0.3`` (:798-800).  Here, as in the JAX
package: nearest-neighbour correspondences from column 0 of the shared 5-NN
(``match/cuda_knn.py::knn5`` — on a CUDA tensor the hand-written kernel
``csrc/knn5.cu``, one launch per iteration), closed-form Horn/Kabsch
alignment (3×3 SVD) per iteration, and PCL's fitness: the mean squared NN
distance over the valid source points that found a correspondence.

The JAX package's ``lax.while_loop`` is a Python loop here with one counted
host read per iteration (``core/device.py::host_bool``): "did the pose move
by more than eps".  ``torch.linalg.svd`` of the 3×3 matrix may synchronise
inside the library on a CUDA tensor; that read is not counted.  The
determinant of the reflection fix is written out (no LU call).
"""

from __future__ import annotations

import threading

import torch

from ..core import se3
from ..core.device import host_bool
from ..match.cuda_knn import knn5

Tensor = torch.Tensor

iteration_count = 0     # +1 per ICP iteration run by icp_align
_count_lock = threading.Lock()


def _det3(M: Tensor) -> Tensor:
    return (M[0, 0] * (M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1])
            - M[0, 1] * (M[1, 0] * M[2, 2] - M[1, 2] * M[2, 0])
            + M[0, 2] * (M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]))


def _horn(src: Tensor, tgt: Tensor, w: Tensor) -> Tensor:
    """Weighted rigid alignment src→tgt: returns pose (6,)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    cs = torch.sum(src * w[:, None], 0) / wsum
    ct = torch.sum(tgt * w[:, None], 0) / wsum
    H = ((src - cs) * w[:, None]).T @ (tgt - ct)
    U, _, Vt = torch.linalg.svd(H)
    det = _det3(Vt.T @ U.T)
    S = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = Vt.T @ S @ U.T
    t = ct - R @ cs
    return torch.cat([se3.matrix_to_rpy(R), t])


def icp_align(src: Tensor, src_valid: Tensor, tgt: Tensor, tgt_valid: Tensor,
              max_iters: int = 30, max_corr_dist: float = 100.0,
              eps: float = 1.0e-6):
    """Align ``src`` onto ``tgt``.

    Returns (pose (6,) such that ``apply(pose, src) ≈ tgt``,
    fitness (mean squared NN distance), n_corr) as () tensors.  Each
    iteration adds one to :data:`iteration_count`.
    """
    global iteration_count
    max_d2 = max_corr_dist ** 2

    def nn_fit(pose):
        moved = se3.apply(pose, src)
        idx, d2s = knn5(moved, src_valid, tgt, tgt_valid)
        match = tgt[idx[:, 0].to(torch.int64)]
        # exact distances for weights and PCL-style fitness
        d2 = torch.sum((moved - match) ** 2, dim=-1)
        d2 = torch.where(d2s[:, 0] >= 1e30, d2s[:, 0], d2)   # no candidate
        w = (src_valid & (d2 < max_d2) & torch.isfinite(d2)).to(
            torch.float32)
        return moved, match, w, d2

    pose = torch.zeros((6,), dtype=src.dtype, device=src.device)
    it = 0
    while it < max_iters:
        moved, match, w, _ = nn_fit(pose)
        corr = _horn(moved, match, w)
        new_pose = se3.compose(corr, pose)
        delta = torch.sum((new_pose - pose) ** 2)
        pose = new_pose
        it += 1
        with _count_lock:
            iteration_count += 1
        if not host_bool(delta > eps):
            break

    _, _, w, d2 = nn_fit(pose)
    n_corr = torch.sum(w)
    fitness = torch.sum(torch.where(w > 0, d2, 0.0)) / torch.clamp(
        n_corr, min=1.0)
    return pose, fitness, n_corr

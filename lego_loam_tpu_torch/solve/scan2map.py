"""Stage 3a — scan-to-map refinement.

Reimplementation of ``MapOptimization::scan2MapOptimization``
(``mapOptmization.cpp:1315-1332``) and its per-iteration helpers
``cornerOptimization`` (:1028-1134), ``surfOptimization`` (:1136-1197),
``LMOptimization`` (:1199-1312):

* 5-NN against the assembled submap replacing the per-point KD-tree
  queries — ``match/cuda_knn.py::knn5_grouped``: the corner and the surf
  search of one re-association are ONE launch of the hand-written kernel on
  the card;
* corner: 5-point covariance eigendecomposition; a neighbourhood is a line
  iff λ_max > 3 λ_mid; point-to-line residual against the principal
  direction through the centroid (vector form — see solve/odometry.py for
  why the unsigned scalar is avoided);
* surf: 5-point plane fit (centred-covariance smallest eigenvector —
  better conditioned than the reference's ``A·n = −1`` on raw world
  coords, see ``_surf_assoc``); reject if any neighbour deviates
  > 0.2 m; signed point-to-plane residual;
* weights 1−0.9·|d| (corner) and 1−0.9·|d|/⁴√‖p_local‖ (surf — the
  reference uses the *map-frame* norm at :1183, which grows with distance
  travelled; we use the sensor-frame norm, which is what the formula is
  for), keep > 0.1;
* full 6-DoF GN, eigenvalue degeneracy guard at threshold 100, ≤10
  iterations, 0.05 deg / 0.05 cm convergence, ≥50 points.

The weights are constants of the association (the JAX package stops their
gradient), so the Jacobian of the weighted residual is the weight times the
closed-form Jacobian of the plain residual, written out here.

Loop form: a Python loop; the convergence flag is read on the host once per
iteration (``host_bool``), the thin-map gate once per call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..core.device import host_bool
from ..core.linalg3 import eigvals_sym3, principal_eigvec_sym3
from ..match.cuda_knn import knn5_grouped

Tensor = torch.Tensor


class MapCloud(NamedTuple):
    """A fixed-capacity masked map point set."""
    xyz: Tensor     # (M, 3) world frame
    valid: Tensor   # (M,)


def _neighbourhoods(worlds, valids, clouds, cfg: LegoLoamConfig):
    """5-NN of every point of every (points, map) pair, searched together,
    + the gate shared by both associations: all five exist and lie within
    ``neighbor_radius`` (exact distances).  One ``(nb, near_ok)`` a pair."""
    m = cfg.mapping
    found = knn5_grouped([
        (w.contiguous(), v.contiguous(), c.xyz.contiguous(),
         c.valid.contiguous())
        for w, v, c in zip(worlds, valids, clouds)])
    out = []
    for world, cloud, (idx, d2) in zip(worlds, clouds, found):
        nb = cloud.xyz[idx.to(torch.int64)]              # (N,5,3)
        # gate on EXACT distances recomputed from the gathered points
        # (difference-first), and detect "fewer than 5 candidates" by the
        # +inf marker in the fifth slot
        diff = nb - world[:, None, :]
        d2_exact = torch.sum(diff * diff, dim=-1)
        invalid5 = d2[:, 4] >= 1e30                      # <5 candidates
        near_ok = (torch.max(d2_exact, dim=1).values
                   < m.neighbor_radius ** 2) & ~invalid5     # :1037
        out.append((nb, near_ok))
    return out


def _corner_assoc(world: Tensor, pts_valid: Tensor, nb: Tensor,
                  near_ok: Tensor, cfg: LegoLoamConfig):
    """Associate corner points (already in the map frame, with their 5-NN
    ``nb`` and gate ``near_ok``) with line-like neighbourhoods.

    Returns (centroid (N,3), line dir u (N,3), weight (N,)) — constants
    for the subsequent GN iteration (``cornerOptimization``,
    ``mapOptmization.cpp:1028-1134``).
    """
    m = cfg.mapping
    centroid = torch.mean(nb, dim=1)
    d = nb - centroid[:, None, :]
    cov = torch.einsum("nki,nkj->nij", d, d) / 5.0
    evals = eigvals_sym3(cov)                            # ascending
    is_line = evals[:, 2] > m.corner_line_eig_ratio * evals[:, 1]
    u = principal_eigvec_sym3(cov, evals[:, 2])          # principal dir

    v = world - centroid
    r = v - torch.sum(v * u, dim=-1, keepdim=True) * u
    dist = torch.sqrt(torch.sum(r * r, dim=-1))
    w = 1.0 - 0.9 * dist                                 # :1129
    ok = pts_valid & near_ok & is_line & (w > 0.1)
    return centroid, u, torch.where(ok, w, 0.0)


def _surf_assoc(world: Tensor, pts: Tensor, pts_valid: Tensor, nb: Tensor,
                near_ok: Tensor, cfg: LegoLoamConfig):
    """Associate surf points (``pts`` in the sensor frame, ``world`` in the
    map frame, with their 5-NN ``nb`` and gate ``near_ok``) with planar
    neighbourhoods.

    Returns (unit normal (N,3), offset (N,), weight (N,)) —
    (``surfOptimization``, ``mapOptmization.cpp:1136-1197``).
    """
    m = cfg.mapping
    # Plane fit: centred covariance, normal = smallest eigenvector.  The
    # reference solves A·n = −1 on RAW map coordinates (:1146-1153),
    # whose normal equations condition as (‖p‖/spread)² — in f32 the
    # normal estimate visibly degrades hundreds of metres from the
    # origin.  The centred eigen-fit is the same plane, exactly
    # conditioned at any offset (difference-first), reusing the
    # closed-form 3×3 eig the corner path already uses.
    centroid = torch.mean(nb, dim=1)
    dnb = nb - centroid[:, None, :]
    cov = torch.einsum("nki,nkj->nij", dnb, dnb) / 5.0
    evals = eigvals_sym3(cov)
    n_unit = principal_eigvec_sym3(cov, evals[:, 0])     # smallest
    pd = -torch.sum(n_unit * centroid, dim=-1)

    plane_dev = torch.abs(torch.einsum("nki,ni->nk", dnb, n_unit))
    plane_ok = torch.all(plane_dev <= m.plane_fit_tolerance, dim=1)

    dist = torch.sum((world - centroid) * n_unit, dim=-1)    # signed
    local_rng = torch.sqrt(torch.sum(pts * pts, dim=-1))
    w = 1.0 - 0.9 * torch.abs(dist) / torch.sqrt(
        torch.sqrt(torch.clamp(local_rng, min=1e-9)))    # :1180-1184
    ok = pts_valid & near_ok & plane_ok & (w > 0.1)
    return n_unit, pd, torch.where(ok, w, 0.0)


def _associate(pose: Tensor, corner_pts: Tensor, corner_valid: Tensor,
               surf_pts: Tensor, surf_valid: Tensor, corner_map: MapCloud,
               surf_map: MapCloud, cfg: LegoLoamConfig):
    """One re-association: both clouds into the map frame, both 5-NN
    searches in one go, then the two fits."""
    world_c = se3.apply(pose, corner_pts)
    world_s = se3.apply(pose, surf_pts)
    (nb_c, ok_c), (nb_s, ok_s) = _neighbourhoods(
        (world_c, world_s), (corner_valid, surf_valid),
        (corner_map, surf_map), cfg)
    return (_corner_assoc(world_c, corner_valid, nb_c, ok_c, cfg)
            + _surf_assoc(world_s, surf_pts, surf_valid, nb_s, ok_s, cfg))


def _apply_jac(pose: Tensor, pts: Tensor) -> Tensor:
    """∂(R(rpy)·p + t)/∂pose as (N, 3, 6)."""
    dR = se3.rpy_to_matrix_jac(pose[:3])                 # (3, 3, 3)
    rot = torch.einsum("kij,nj->nik", dR, pts)           # (N, 3, 3)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(
        pts.shape[0], 3, 3)
    return torch.cat([rot, eye], dim=-1)


def scan_to_map(pose0: Tensor, corner_pts: Tensor, corner_valid: Tensor,
                surf_pts: Tensor, surf_valid: Tensor,
                corner_map: MapCloud, surf_map: MapCloud,
                cfg: LegoLoamConfig) -> Tensor:
    """Refine the map-frame pose.  Skipped when the submap is too thin
    (corner ≤ 10 ∨ surf ≤ 100, ``mapOptmization.cpp:1316``)."""
    m = cfg.mapping
    dev = pose0.device
    enough = ((torch.sum(corner_map.valid) > m.min_corner_map)
              & (torch.sum(surf_map.valid) > m.min_surf_map))
    if not host_bool(enough):
        return pose0

    eye6 = torch.eye(6, dtype=pose0.dtype, device=dev)
    pose = pose0
    P = eye6
    degenerate = torch.zeros((), dtype=torch.bool, device=dev)
    A = None
    for it in range(m.scan2map_iters):
        # Associate every ``scan2map_reassoc_every`` iterations (constants
        # for the GN steps in between).  The reference re-runs its KD
        # searches every iteration (:1325-1327) — equivalent to =1 here —
        # but late-iteration pose deltas are below the convergence
        # thresholds (0.05 deg / 0.05 cm), so the 5-NN sets don't change.
        fresh = (m.scan2map_reassoc_every <= 1
                 or it % m.scan2map_reassoc_every == 0)
        if fresh:
            A = _associate(pose, corner_pts, corner_valid, surf_pts,
                           surf_valid, corner_map, surf_map, cfg)
        centroid, u, wc, n_pl, pd, ws = A
        n_sel = torch.sum(wc > 0) + torch.sum(ws > 0)

        # weighted residuals and their closed-form Jacobians
        xc = se3.apply(pose, corner_pts)
        v = xc - centroid
        rc = v - torch.sum(v * u, dim=-1, keepdim=True) * u
        dxc = _apply_jac(pose, corner_pts)                       # (Nc,3,6)
        Jc = dxc - u[..., None] * torch.sum(u[..., None] * dxc, dim=1,
                                            keepdim=True)
        xs = se3.apply(pose, surf_pts)
        rs = torch.sum(xs * n_pl, dim=-1) + pd
        Js = torch.sum(n_pl[..., None] * _apply_jac(pose, surf_pts), dim=1)

        r = torch.cat([(rc * wc[:, None]).reshape(-1), rs * ws])
        J = torch.cat([(Jc * wc[:, None, None]).reshape(-1, 6),
                       Js * ws[:, None]])                        # (R, 6)
        H = J.T @ J
        g = J.T @ r
        Hd = H + 1e-4 * torch.diag(torch.diag(H)) + 1e-9 * eye6
        dx = -torch.linalg.solve_ex(Hd, g[:, None],
                                    check_errors=False).result[:, 0]

        if it == 0:
            # a non-finite H (its step is zeroed below) must not make the
            # eigensolver raise
            evals, V = torch.linalg.eigh(
                torch.where(torch.isfinite(H).all(), H, eye6))
            keep = evals >= m.degeneracy_eig_threshold    # :1274 (=100)
            P = (V * keep[None, :].to(V.dtype)) @ V.T
            degenerate = ~torch.all(keep)
        dx = torch.where(degenerate, P @ dx, dx)
        dx = torch.where(torch.isnan(dx) | (n_sel < m.min_selected_points),
                         torch.zeros_like(dx), dx)
        pose = pose + dx

        d_rot = torch.sqrt(torch.sum(dx[:3] ** 2))
        d_tr = torch.sqrt(torch.sum(dx[3:] ** 2))
        # Convergence may only be declared on an iteration that ran a
        # fresh association: a small dx on a frozen-correspondence
        # iteration can mean "stale constraints", not "converged"
        # (the reference re-searches every iteration, :1325-1327).
        if fresh:
            converged = ((d_rot * (180.0 / math.pi) < m.delta_r_converged_deg)
                         & (d_tr * 100.0 < m.delta_t_converged_cm))
            if host_bool(converged):
                break
    return pose

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
iteration that re-associated (``host_bool``), the thin-map gate once per
call.  On a CUDA card the iterations replay from CUDA graphs around an
eager K2 launch (:func:`refine`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import graphs, se3
from ..core.config import LegoLoamConfig
from ..core.device import host_bool
from ..core.linalg3 import eigvals_sym3, principal_eigvec_sym3
from ..match.cuda_knn import knn5_grouped

Tensor = torch.Tensor


class MapCloud(NamedTuple):
    """A fixed-capacity masked map point set."""
    xyz: Tensor     # (M, 3) world frame
    valid: Tensor   # (M,)


def _search(worlds, valids, clouds):
    """5-NN of every point of every (points, map) pair, searched together:
    one launch of K2 on the card, called eagerly (it stays outside every
    replayed chain).  One ``(idx, d2)`` a pair."""
    return knn5_grouped([
        (w.contiguous(), v.contiguous(), c.xyz.contiguous(),
         c.valid.contiguous())
        for w, v, c in zip(worlds, valids, clouds)])


def _near(world: Tensor, cloud: MapCloud, idx: Tensor, d2: Tensor,
          cfg: LegoLoamConfig):
    """The 5-NN ``nb`` of a search and the gate shared by both
    associations: all five exist and lie within ``neighbor_radius`` (exact
    distances).  Returns ``(nb, near_ok)``."""
    m = cfg.mapping
    nb = cloud.xyz[idx.to(torch.int64)]                  # (N,5,3)
    # gate on EXACT distances recomputed from the gathered points
    # (difference-first), and detect "fewer than 5 candidates" by the
    # +inf marker in the fifth slot
    diff = nb - world[:, None, :]
    d2_exact = torch.sum(diff * diff, dim=-1)
    invalid5 = d2[:, 4] >= 1e30                          # <5 candidates
    near_ok = (torch.max(d2_exact, dim=1).values
               < m.neighbor_radius ** 2) & ~invalid5     # :1037
    return nb, near_ok


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


def _to_map(pose: Tensor, corner_pts: Tensor, surf_pts: Tensor):
    """Both clouds into the map frame."""
    return se3.apply(pose, corner_pts), se3.apply(pose, surf_pts)


def _fits(world_c: Tensor, world_s: Tensor, found, corner_valid: Tensor,
          surf_pts: Tensor, surf_valid: Tensor, corner_map: MapCloud,
          surf_map: MapCloud, cfg: LegoLoamConfig):
    """The two fits of one re-association, from its search's ``found``:
    (centroid, u, wc, n_pl, pd, ws)."""
    (idx_c, d2_c), (idx_s, d2_s) = found
    nb_c, ok_c = _near(world_c, corner_map, idx_c, d2_c, cfg)
    nb_s, ok_s = _near(world_s, surf_map, idx_s, d2_s, cfg)
    return (_corner_assoc(world_c, corner_valid, nb_c, ok_c, cfg)
            + _surf_assoc(world_s, surf_pts, surf_valid, nb_s, ok_s, cfg))


def _apply_jac(pose: Tensor, pts: Tensor) -> Tensor:
    """∂(R(rpy)·p + t)/∂pose as (N, 3, 6)."""
    dR = se3.rpy_to_matrix_jac(pose[:3])                 # (3, 3, 3)
    rot = torch.einsum("kij,nj->nik", dR, pts)           # (N, 3, 3)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(
        pts.shape[0], 3, 3)
    return torch.cat([rot, eye], dim=-1)


_EYE6 = tuple(tuple(float(i == j) for j in range(6)) for i in range(6))


def _normal_equations(pose: Tensor, corner_pts: Tensor, surf_pts: Tensor,
                      A, cfg: LegoLoamConfig):
    """One GN iteration's linearisation on the association ``A``: the
    weighted residuals, their closed-form Jacobians and the damped normal
    equations.  Returns (H, Hd, g, n_sel)."""
    centroid, u, wc, n_pl, pd, ws = A
    n_sel = torch.sum(wc > 0) + torch.sum(ws > 0)

    xc = se3.apply(pose, corner_pts)
    v = xc - centroid
    rc = v - torch.sum(v * u, dim=-1, keepdim=True) * u
    dxc = _apply_jac(pose, corner_pts)                           # (Nc,3,6)
    Jc = dxc - u[..., None] * torch.sum(u[..., None] * dxc, dim=1,
                                        keepdim=True)
    xs = se3.apply(pose, surf_pts)
    rs = torch.sum(xs * n_pl, dim=-1) + pd
    Js = torch.sum(n_pl[..., None] * _apply_jac(pose, surf_pts), dim=1)

    r = torch.cat([(rc * wc[:, None]).reshape(-1), rs * ws])
    J = torch.cat([(Jc * wc[:, None, None]).reshape(-1, 6),
                   Js * ws[:, None]])                            # (R, 6)
    H = J.T @ J
    g = J.T @ r
    Hd = H + 1e-4 * torch.diag(torch.diag(H)) \
        + 1e-9 * graphs.constant(_EYE6, pose.dtype, pose.device)
    return H, Hd, g, n_sel


def _degeneracy(H: Tensor, cfg: LegoLoamConfig):
    """The first iteration's degeneracy guard (:1274): the projection P
    onto the well-constrained directions of H, and whether any is not.
    Eager: ``eigh`` checks its errors on the host."""
    eye6 = graphs.constant(_EYE6, H.dtype, H.device)
    # a non-finite H (its step is zeroed below) must not make the
    # eigensolver raise
    evals, V = torch.linalg.eigh(torch.where(torch.isfinite(H).all(), H, eye6))
    keep = evals >= cfg.mapping.degeneracy_eig_threshold      # :1274 (=100)
    P = (V * keep[None, :].to(V.dtype)) @ V.T
    return P, ~torch.all(keep)


def _update(pose: Tensor, Hd: Tensor, g: Tensor, P: Tensor,
            degenerate: Tensor, n_sel: Tensor, cfg: LegoLoamConfig):
    """The step: the 6x6 solve, projected, zeroed where unusable, applied to
    the pose; returns (pose, converged)."""
    m = cfg.mapping
    dx = -torch.linalg.solve_ex(Hd, g[:, None],
                                check_errors=False).result[:, 0]
    dx = torch.where(degenerate, P @ dx, dx)
    dx = torch.where(torch.isnan(dx) | (n_sel < m.min_selected_points),
                     torch.zeros_like(dx), dx)
    pose = pose + dx

    d_rot = torch.sqrt(torch.sum(dx[:3] ** 2))
    d_tr = torch.sqrt(torch.sum(dx[3:] ** 2))
    converged = ((d_rot * (180.0 / math.pi) < m.delta_r_converged_deg)
                 & (d_tr * 100.0 < m.delta_t_converged_cm))
    return pose, converged


def _first_iteration(pose, corner_pts, corner_valid, surf_pts, surf_valid,
                     corner_map, surf_map, world_c, world_s, found, cfg):
    """Iteration 0 up to the degeneracy guard: the fits on the search's
    ``found`` and the normal equations.  Returns (A, H, Hd, g, n_sel)."""
    A = _fits(world_c, world_s, found, corner_valid, surf_pts, surf_valid,
              corner_map, surf_map, cfg)
    return (A,) + _normal_equations(pose, corner_pts, surf_pts, A, cfg)


def _fresh_iteration(pose, corner_pts, corner_valid, surf_pts, surf_valid,
                     corner_map, surf_map, world_c, world_s, found, P,
                     degenerate, cfg):
    """A later iteration that re-associated: the fits, the normal equations
    and the update.  Returns (A, pose, converged)."""
    A = _fits(world_c, world_s, found, corner_valid, surf_pts, surf_valid,
              corner_map, surf_map, cfg)
    _, Hd, g, n_sel = _normal_equations(pose, corner_pts, surf_pts, A, cfg)
    return (A,) + _update(pose, Hd, g, P, degenerate, n_sel, cfg)


def _stale_iteration(pose, corner_pts, surf_pts, A, P, degenerate, cfg):
    """An iteration on the last association: the normal equations and the
    update.  Returns the pose."""
    _, Hd, g, n_sel = _normal_equations(pose, corner_pts, surf_pts, A, cfg)
    return _update(pose, Hd, g, P, degenerate, n_sel, cfg)[0]


def map_is_thick(corner_map: MapCloud, surf_map: MapCloud,
                 cfg: LegoLoamConfig) -> Tensor:
    """The thin-map gate (corner > 10 ∧ surf > 100,
    ``mapOptmization.cpp:1316``) as a () bool on the device."""
    m = cfg.mapping
    return ((torch.sum(corner_map.valid) > m.min_corner_map)
            & (torch.sum(surf_map.valid) > m.min_surf_map))


def scan_to_map(pose0: Tensor, corner_pts: Tensor, corner_valid: Tensor,
                surf_pts: Tensor, surf_valid: Tensor,
                corner_map: MapCloud, surf_map: MapCloud,
                cfg: LegoLoamConfig) -> Tensor:
    """Refine the map-frame pose.  Skipped when the submap is too thin
    (:func:`map_is_thick`)."""
    return graphs.owned(refine(
        pose0, corner_pts, corner_valid, surf_pts, surf_valid, corner_map,
        surf_map, map_is_thick(corner_map, surf_map, cfg), cfg))


def refine(pose0: Tensor, corner_pts: Tensor, corner_valid: Tensor,
           surf_pts: Tensor, surf_valid: Tensor, corner_map: MapCloud,
           surf_map: MapCloud, thick: Tensor, cfg: LegoLoamConfig) -> Tensor:
    """:func:`scan_to_map` with its thin-map gate ``thick`` given (the
    mapping cycle computes it with the submap).

    On a CUDA card each iteration replays from CUDA graphs
    (``core/graphs.py``): the pose applied to both clouds, then K2 launched
    eagerly, then the fits, normal equations and update as one chain (at
    iteration 0 the eager ``eigh`` of the degeneracy guard runs between the
    normal equations and the update); an iteration on the last association
    is one chain.  The returned pose may be a graph's buffer, which the
    next call of this function overwrites."""
    m = cfg.mapping
    if not host_bool(thick):
        return pose0

    pose = pose0
    for it in range(m.scan2map_iters):
        # Associate every ``scan2map_reassoc_every`` iterations (constants
        # for the GN steps in between).  The reference re-runs its KD
        # searches every iteration (:1325-1327) — equivalent to =1 here —
        # but late-iteration pose deltas are below the convergence
        # thresholds (0.05 deg / 0.05 cm), so the 5-NN sets don't change.
        fresh = (m.scan2map_reassoc_every <= 1
                 or it % m.scan2map_reassoc_every == 0)
        if not fresh:
            pose = graphs.run(_stale_iteration, pose, corner_pts, surf_pts,
                              A, P, degenerate, cfg)
            continue
        world_c, world_s = graphs.run(_to_map, pose, corner_pts, surf_pts)
        found = _search((world_c, world_s), (corner_valid, surf_valid),
                        (corner_map, surf_map))
        scan = (corner_pts, corner_valid, surf_pts, surf_valid, corner_map,
                surf_map, world_c, world_s, found)
        if it == 0:
            A, H, Hd, g, n_sel = graphs.run(_first_iteration, pose, *scan,
                                            cfg)
            P, degenerate = _degeneracy(H, cfg)
            pose, converged = graphs.run(_update, pose, Hd, g, P,
                                         degenerate, n_sel, cfg)
        else:
            A, pose, converged = graphs.run(_fresh_iteration, pose, *scan, P,
                                            degenerate, cfg)
        # Convergence may only be declared on an iteration that ran a
        # fresh association: a small dx on a frozen-correspondence
        # iteration can mean "stale constraints", not "converged"
        # (the reference re-searches every iteration, :1325-1327).
        if host_bool(converged):
            break
    return pose

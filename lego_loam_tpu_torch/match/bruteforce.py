"""Brute-force nearest-neighbour search over dense distance matrices.

Replacement for the reference's nanoflann KD-trees (``nanoflann_pcl.h:79-85``;
used 7× across FA/MO).  Feature clouds here are small (10²-10⁴ points), so
an exact distance matrix via one matmul (‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b) is
simple and batchable.  Masked candidates are pushed to +inf before the
argmin; ``argmin`` returns the first minimum, so ties resolve to the lower
candidate index.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_INF = 3e38


def pairwise_sqdist(a: Tensor, b: Tensor) -> Tensor:
    """(Q,3) × (M,3) → (Q,M) squared distances via one matmul.

    Numerics matter here: the ‖a‖²+‖b‖²−2a·b expansion cancels
    catastrophically when coordinates sit far from the origin, and any
    truncation of the matmul inputs (TF32 on this card — switched off in
    the package ``__init__``) multiplies the damage, silently defeating
    every radius gate downstream once the vehicle drives away from its
    start.  Both sides are recentred by the query centroid (a translation
    leaves distances unchanged but shrinks the cancelling terms to local
    extent) and the product runs in full float32.  The result is good for
    RANKING; call sites that gate on absolute thresholds (scan-to-map 1 m²
    neighbourhoods) recompute exact difference-first distances for the
    selected winners.
    """
    center = torch.mean(a, dim=0)
    a = a - center
    b = b - center
    a2 = torch.sum(a * a, -1)[:, None]
    b2 = torch.sum(b * b, -1)[None, :]
    cross = a @ b.T
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def masked_nn(d2: Tensor, cand_valid: Tensor):
    """Per-row argmin over valid candidates.

    Returns (idx (Q,) int32, dist2 (Q,)); rows with no valid candidate get
    dist2=+inf and idx=0.
    """
    d2m = torch.where(cand_valid[None, :], d2, _INF)
    dist2, idx = torch.min(d2m, dim=-1)
    return idx.to(torch.int32), dist2


def nn_in_ring_window(d2: Tensor, cand_ring: Tensor, cand_valid: Tensor,
                      center_ring: Tensor, lo: float, hi: float,
                      exclude_center_ring: bool = False,
                      side: str = "both"):
    """Nearest candidate whose ring lies in a window around ``center_ring``.

    Reproduces the reference's index-ordered ±2.5-ring scans
    (``featureAssociation.cpp:520-565, 656-725``) as a masked argmin:

    * ``side='both'``: ring ∈ [center+lo, center+hi]
    * ``exclude_center_ring``: additionally ring ≠ center (corner line
      second point must come from a different ring)

    Args:
      d2: (Q, M) squared distances.
      cand_ring: (M,) candidate ring numbers.
      cand_valid: (M,).
      center_ring: (Q,) ring of each query's closest point.
      lo, hi: scalars (window offsets, e.g. −2.5 / +2.5).

    Returns (idx (Q,) int32, dist2 (Q,)).
    """
    del side
    r = cand_ring[None, :]
    c = center_ring[:, None]
    in_win = (r >= c + lo) & (r <= c + hi)
    if exclude_center_ring:
        in_win = in_win & (torch.floor(r) != torch.floor(c))
    d2m = torch.where(in_win & cand_valid[None, :], d2, _INF)
    dist2, idx = torch.min(d2m, dim=-1)
    return idx.to(torch.int32), dist2


def knn(query: Tensor, query_valid: Tensor, cand: Tensor, cand_valid: Tensor,
        k: int):
    """Exact k-NN (small k) via iterated masked argmin.

    Returns (idx (Q,k) int32, dist2 (Q,k)) sorted ascending.
    """
    d2 = pairwise_sqdist(query, cand)
    d2 = torch.where(cand_valid[None, :], d2, _INF)
    d2 = torch.where(query_valid[:, None], d2, _INF)

    ar = torch.arange(d2.shape[1], device=d2.device)
    idxs, dists = [], []
    for _ in range(k):
        d, i = torch.min(d2, dim=-1)
        idxs.append(i.to(torch.int32))
        dists.append(d)
        d2 = torch.where(ar[None, :] == i[:, None], _INF, d2)
    return torch.stack(idxs, -1), torch.stack(dists, -1)


def knn_chunked(query: Tensor, query_valid: Tensor, cand: Tensor,
                cand_valid: Tensor, k: int):
    """k-NN against a large candidate set as an exact ``topk`` over the
    full distance matrix (the JAX package uses an approximate hardware
    top-k here; PyTorch has none, and exact is within that contract).

    Returns (idx (Q,k) int32, dist2 (Q,k)) ascending; invalid queries get
    +inf.
    """
    d2 = pairwise_sqdist(query, cand)
    d2 = torch.where(cand_valid[None, :], d2, _INF)
    best_d, best_i = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    best_d = torch.where(query_valid[:, None], best_d, _INF)
    return best_i.to(torch.int32), best_d

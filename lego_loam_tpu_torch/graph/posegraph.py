"""Pose-graph factor storage.

The reference hands keyframe poses to gtsam iSAM2 (PriorFactor +
BetweenFactor chain + loop BetweenFactors, ``mapOptmization.cpp:1335-1478``).
Without loop factors the chain's exact MAP solution is the composed
odometry, so the loop-closure-off pipeline only RECORDS the prior and the
between factors; the solver that consumes them (Gauss-Newton over all
keyframe poses with a cyclic-reduction preconditioned CG) belongs to the
loop-closure path and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.types import Container

Tensor = torch.Tensor


@dataclasses.dataclass
class FactorGraph(Container):
    """Fixed-capacity factor storage.

    Between factors i→j carry measurement z (6,) = pose of j in i's frame
    and a per-component weight (1/σ).  The odometry chain is factors
    (k−1→k); loop factors append after them.
    """
    i: Tensor          # (F,) int32
    j: Tensor          # (F,) int32
    z: Tensor          # (F, 6)
    weight: Tensor     # (F, 6)
    valid: Tensor      # (F,)
    prior: Tensor      # (6,) pose anchor for node 0
    prior_weight: Tensor  # (6,)


def empty_graph(capacity: int, device: DeviceLike = None) -> FactorGraph:
    device = resolve_device(device)
    return FactorGraph(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        z=torch.zeros((capacity, 6), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity, 6), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        prior=torch.zeros((6,), dtype=torch.float32, device=device),
        prior_weight=torch.full((6,), 1e3, dtype=torch.float32,
                                device=device))


def add_factor(g: FactorGraph, count: Tensor, i: Tensor, j: Tensor, z: Tensor,
               weight: Tensor, enable: Optional[Tensor] = None):
    """Append one factor at slot ``count`` (no-op when full, or when the
    optional () bool ``enable`` is False).  Returns (new graph, new count);
    the given graph is not written."""
    cap = g.i.shape[0]
    slot = torch.clamp(count, max=cap - 1).reshape(1).to(torch.int64)
    ok = count < cap
    if enable is not None:
        ok = ok & enable

    def put(arr, new):
        new = torch.as_tensor(new, dtype=arr.dtype, device=arr.device)
        old = arr.index_select(0, slot)
        return arr.index_copy(0, slot, torch.where(ok, new[None], old))

    g = g.replace(
        i=put(g.i, i), j=put(g.j, j), z=put(g.z, z),
        weight=put(g.weight, weight), valid=put(g.valid, True))
    return g, count + ok.to(count.dtype)

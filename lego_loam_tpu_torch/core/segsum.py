"""Sums of rows into slots in an order fixed by the input alone.

``index_add_`` on a CUDA tensor adds floats with atomics, in whatever order
the threads arrive, so two runs on the same input differ in the last bits,
and a SLAM replay amplifies those bits into centimetres.  Here the rows are
put in slot order by a STABLE sort and each slot's run is summed from its
first row to its last (``torch.segment_reduce``: one thread a slot and
column, a sequential loop, on the card and on the CPU alike).  The order is
the rows' own order within a slot, which is also the order of a sequential
``index_add_`` on the CPU, so there the bits are those of ``index_add_``.

A :class:`Segments` plan is made once for a slot vector and reused by every
sum over it: the pose-graph solve sums over the same incidence in every PCG
iteration.  Rows whose slot is ``num_slots`` or more fall into one trailing
run that is summed and dropped (the scratch slot of the callers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Segments:
    """Rows of one slot vector in slot order, as runs."""

    order: Optional[Tensor]   # (N,) int64 stable sort of the slots; None: sorted
    offsets: Tensor           # (num_slots + 2,) int64 run starts, then N
    num_slots: int


def segments(slot: Tensor, num_slots: int, presorted: bool = False) -> Segments:
    """Plan the sums over ``slot`` (N,) into ``num_slots`` slots.  With
    ``presorted`` the caller promises ``slot`` is non-decreasing (the voxel
    filter's runs), and no sort is made."""
    slot = slot.to(torch.int64)
    order = None
    if not presorted:
        slot, order = torch.sort(slot, stable=True)
    starts = torch.searchsorted(
        slot, torch.arange(num_slots + 1, device=slot.device))
    end = torch.full((1,), slot.shape[0], dtype=torch.int64,
                     device=slot.device)
    return Segments(order, torch.cat([starts, end]), num_slots)


def segment_sum(values: Tensor, seg: Segments) -> Tensor:
    """(num_slots, …) sums of the rows of ``values`` (N, …) by slot."""
    if seg.order is not None:
        values = values.index_select(0, seg.order)
    out = torch.segment_reduce(values, "sum", offsets=seg.offsets,
                               unsafe=True)
    return out[:seg.num_slots]

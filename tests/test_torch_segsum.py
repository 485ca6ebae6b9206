"""``core/segsum.py``, the order-fixed sums that replace float
``index_add_`` (whose CUDA atomics add in no fixed order): held to a
float64 ``index_add_`` within 1e-5 relative, bit-equal from call to call,
and on the CPU bit-equal to a float32 ``index_add_`` (the same sequential
order), on unsorted, presorted and dropped slots."""

import os
import re

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch.core.segsum import segment_sum, segments

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lego_loam_tpu_torch")


@pytest.mark.parametrize("shape,presorted", [((3,), False), ((6, 6), False),
                                             ((4,), True), ((), False)])
def test_segment_sum_equals_index_add(shape, presorted):
    rng = np.random.default_rng(7)
    N, S = 5000, 300
    slot = rng.integers(0, S + 40, size=N)      # slots ≥ S are dropped
    slot[rng.random(N) < 0.3] = 17              # one long run
    if presorted:
        slot = np.sort(slot)
    vals = (rng.normal(size=(N,) + shape) * 100.0).astype(np.float32)
    s, v = torch.from_numpy(slot), torch.from_numpy(vals)
    plan = segments(s, S, presorted=presorted)
    got = segment_sum(v, plan)
    assert got.shape == (S,) + shape and got.dtype == torch.float32
    keep = s < S
    ref64 = torch.zeros((S,) + shape, dtype=torch.float64).index_add_(
        0, s[keep], v[keep].double())
    scale = torch.clamp(torch.zeros_like(ref64).index_add_(
        0, s[keep], v[keep].double().abs()), min=1.0)
    assert float(torch.max(torch.abs(got.double() - ref64) / scale)) < 1e-5
    assert torch.equal(segment_sum(v, segments(s, S, presorted)), got)
    assert torch.equal(segment_sum(v, plan), got)
    ref32 = torch.zeros((S,) + shape).index_add_(0, s[keep], v[keep])
    assert torch.equal(got, ref32)              # the CPU's sequential order
    empty = ~torch.isin(torch.arange(S), s)
    assert empty.any() and torch.all(got[empty] == 0)


def test_no_float_index_add_left_in_the_port():
    """Every ``index_add`` left in the port's sources sums integers or
    writes each slot once (order-free on the card)."""
    allowed = {
        ("frontend", "segmentation.py"): "integer counts",
        ("map2d", "grid.py"): "integer ray counts",
        ("solve", "odometry.py"): "distinct free indices, one add a slot",
    }
    found = set()
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                if re.search(r"\.index_add_?\(", f.read()):
                    found.add((os.path.basename(root), name))
    assert found <= set(allowed), found - set(allowed)

"""The stage reference (``slam_bench/reference/stages.py``) against the
program's plain CPU versions of the same stages, and against answers made
wrong on purpose."""

import numpy as np
import pytest
import torch

from slam_bench.reference import stages


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_equal_the_plain_labelling(seed):
    from lego_loam_tpu_torch.frontend.cuda_label import (
        SENTINEL, propagate_labels_torch)
    g = torch.Generator().manual_seed(seed)
    V, H = 8, 60
    seg = torch.rand((V, H), generator=g) < 0.7
    right = torch.rand((V, H), generator=g) < 0.6
    down = torch.rand((V, H), generator=g) < 0.6
    # the caller's edges join segmentable pixels only
    right &= seg & torch.roll(seg, -1, 1)
    down[:-1] &= seg[:-1] & seg[1:]
    down[-1] = False
    flat = torch.arange(V * H, dtype=torch.int32).reshape(V, H)
    labels0 = torch.where(seg, flat, SENTINEL)
    plain = propagate_labels_torch(labels0, right, down, 10 ** 4)
    assert stages.label_errors(labels0, right, down, plain) == 0
    wrong = plain.clone()
    wrong.view(-1)[seg.reshape(-1).nonzero()[0]] += 1
    assert stages.label_errors(labels0, right, down, wrong) == 1


def test_knn5_excess_is_nought_for_the_plain_search_only():
    from lego_loam_tpu_torch.match.cuda_knn import knn5_torch
    g = torch.Generator().manual_seed(3)
    q = torch.rand((50, 3), generator=g) * 10
    c = torch.rand((400, 3), generator=g) * 10
    qv = torch.rand(50, generator=g) < 0.9
    cv = torch.rand(400, generator=g) < 0.8
    idx, _ = knn5_torch(q, qv, c, cv)
    ex = stages.knn5_excess(q, qv, c, cv, idx)
    assert ex.numel() == int(qv.sum()) and float(ex.max()) < 1e-5
    dup = idx.clone()
    dup[:, 4] = dup[:, 3]
    assert float(stages.knn5_excess(q, qv, c, cv, dup).max()) == float("inf")
    far = idx.clone()
    far[:, 0] = int((~cv).nonzero()[0])       # an invalid candidate
    assert float(stages.knn5_excess(q, qv, c, cv, far).max()) == float("inf")


def test_nn_excess_after_the_deskew():
    g = torch.Generator().manual_seed(4)
    theta = torch.tensor([0.01, -0.02, 0.05, 0.3, -0.1, 0.02])
    xyz = torch.rand((40, 3), generator=g) * 8
    s = torch.rand(40, generator=g)
    valid = torch.ones(40, dtype=torch.bool)
    last = torch.rand((300, 3), generator=g) * 8
    lv = torch.ones(300, dtype=torch.bool)
    # the nearest point of ``last`` to each de-skewed feature, in float64
    R = stages._rpy(theta.double()[None, :3] * s.double()[:, None])
    x = (R @ xyz.double()[:, :, None])[:, :, 0] \
        + theta.double()[None, 3:] * s.double()[:, None]
    nearest = last[torch.cdist(x, last.double()).argmin(1)]
    ex = stages.nn_excess(theta, xyz, s, valid, last, lv, nearest, 25.0)
    assert ex.numel() == 40 and float(ex.abs().max()) < 1e-9
    second = last[torch.cdist(x, last.double()).topk(2, largest=False)
                  .indices[:, 1]]
    ex2 = stages.nn_excess(theta, xyz, s, valid, last, lv, second, 25.0)
    assert float(ex2.min()) > 0


def test_nothing_judged_fails():
    vals = stages.numbers({"labels": [], "odom": [], "knn": [], "scans": 0})
    assert all(np.isnan(vals[k]) for k in
               ("k1_label_errors", "odom_nn_excess_m2", "k2_knn_excess_m2"))

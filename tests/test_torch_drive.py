"""The port over longer drives on the CPU without loop closure's help: a lap
revisited through the radius submap with loop closure off, and stop-and-go
motion with in-place turns.

The sequences and bounds are those of the JAX package's
``tests/test_loop_e2e.py::test_radius_submap_revisit_loop_off`` and
``tests/test_robustness.py::test_aggressive_motion_bounded``, on
``small_loop_cfg`` as the port reads it."""

import numpy as np

from torch_port_util import LAPS, ate_vs_truth, gt_relative, replay_drive


def test_radius_submap_revisit_loop_off():
    """Loop closure off (the reference's default): the live path uses the
    keypose radius submap, so a revisit re-associates against the old map.
    The window is 8 keyframes (~2.4 m), so the latest-N window could not
    cover the revisit: a bounded ATE on lap 2 shows the radius path live."""
    _, seq = LAPS["seed33-r2.2"]
    final, outs, gt = replay_drive(95, seq, enable_loop_closure=False,
                                   surrounding_keyframe_search_num=8)

    meta = final.mapping.meta
    assert int(meta.kf_count) > 12            # more than a lap of keyframes
    # radius mode bypasses the window grid entirely
    assert float(meta.grid.corner_cnt.sum()) == 0.0
    assert float(meta.grid.surf_cnt.sum()) == 0.0

    fused = outs["fused"]
    assert np.isfinite(fused).all()
    m = ate_vs_truth(fused, gt)
    assert m["rmse"] < 0.8, m


def test_aggressive_motion_bounded():
    """Drive, stop, +90° in-place turn, stop, drive: the cross-frame
    relaxation and trust region must track it without diverging or lagging
    into a wrong heading."""
    n = 65
    _, outs, gt = replay_drive(n, dict(seed=21, trajectory="aggressive"))

    fused = outs["fused"]
    assert np.isfinite(fused).all()
    m = ate_vs_truth(fused, gt)
    assert m["rmse"] < 0.8, m
    yaw_err = np.abs(np.unwrap(fused[:-1, 2])
                     - np.unwrap(gt_relative(gt)[1:n, 2]))
    assert float(yaw_err.max()) < 0.75, yaw_err.max()

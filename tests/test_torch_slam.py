"""PyTorch port vs JAX package: the ported slice as a whole.

Twelve scans (two mapping cycles: the first inserts the first keyframe, the
second matches against it) go through ``replay`` on both sides from the same
packed arrays.  The comparison is by trajectory, not pose-by-pose equality:
the pipeline is sensitive to nearest-neighbour tie-breaks, and the two sides
sum in another order, so ``fused`` agrees to 0.05 m / 0.01 rad and the ATE
against ground truth to 0.05 m, while the integer counters are equal."""

import numpy as np
import pytest
import torch

from lego_loam_tpu.io.npz_io import pack_sequence as jpack_sequence
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu_torch.core import device as tdevice
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.pipeline import slam as tslam
from torch_port_util import ate_vs_truth, small_cfgs, tnp, to_np

# a keyframe needs 0.3 m of travel: 1.2 m/s * 0.5 s per mapping cycle = 0.6 m
JCFG, TCFG = small_cfgs()
N_SCANS = 12


@pytest.fixture(scope="module")
def sequence():
    scans, gt, times = make_sequence(N_SCANS, JCFG, seed=5, noise=0.01,
                                     speed=1.2)
    return scans, gt, times


@pytest.fixture(scope="module")
def torch_run(sequence):
    scans, _, times = sequence
    x, v, t = pack_sequence(scans, times, TCFG, device="cpu")
    state, outs = tslam.replay(x, v, t, TCFG, device="cpu")
    return (x, v, t), state, outs


def test_replay_matches_jax(sequence, torch_run):
    scans, gt, times = sequence
    jx, jv, jt = jpack_sequence(scans, times, JCFG)
    (x, v, t), state, outs = torch_run
    np.testing.assert_array_equal(tnp(x), np.asarray(jx))
    np.testing.assert_array_equal(tnp(v), np.asarray(jv))

    jstate, jouts = jslam.replay(jx, jv, jt, JCFG)
    jstate, jouts = to_np(jstate), to_np(jouts)

    assert state.scan_index == int(jstate.scan_index) == N_SCANS
    meta, jmeta = state.mapping.meta, jstate.mapping.meta
    assert int(meta.kf_count) == int(jmeta.kf_count) == 2
    assert int(meta.factor_count) == int(jmeta.factor_count) == 1
    assert int(meta.cycle) == int(jmeta.cycle) == 2
    for name in ("kf_dropped", "factor_dropped", "map_sat"):
        assert int(getattr(meta, name)) == int(getattr(jmeta, name)) == 0
    np.testing.assert_array_equal(tnp(outs["kf_count"]), jouts["kf_count"])
    np.testing.assert_array_equal(tnp(outs["factor_count"]),
                                  jouts["factor_count"])

    for name in ("odom", "fused", "mapped"):
        got, ref = tnp(outs[name]), jouts[name]
        assert got.shape == ref.shape == (N_SCANS, 6)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=0.01,
                                   err_msg=name)
        np.testing.assert_allclose(got[:, 3:], ref[:, 3:], atol=0.05,
                                   err_msg=name)
    # the second cycle really matched against the first keyframe
    assert np.abs(jouts["mapped"][-1] - jouts["odom"][9]).max() > 0
    a, ja = ate_vs_truth(tnp(outs["fused"]), gt), \
        ate_vs_truth(jouts["fused"], gt)
    assert abs(a["rmse"] - ja["rmse"]) < 0.05
    assert a["rmse"] < 1.0      # coarse at this width on both sides


def test_replay_from_split_is_bit_equal(torch_run):
    (x, v, t), whole_state, whole = torch_run
    k = 7                                    # splits inside a mapping period
    s, first = tslam.replay(x[:k], v[:k], t[:k], TCFG, device="cpu")
    s, second = tslam.replay_from(s, x[k:], v[k:], t[k:], TCFG, device="cpu")
    assert s.scan_index == whole_state.scan_index
    for name in whole:
        got = torch.cat([first[name], second[name]])
        np.testing.assert_array_equal(tnp(got), tnp(whole[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(tnp(s.mapping.clouds.surf),
                                  tnp(whole_state.mapping.clouds.surf))
    np.testing.assert_array_equal(tnp(s.mapping.meta.kf_pose),
                                  tnp(whole_state.mapping.meta.kf_pose))


def test_host_reads_are_counted(sequence):
    scans, _, times = sequence
    x, v, t = pack_sequence(scans[:6], times[:6], TCFG, device="cpu")
    tdevice.reset_sync_count()
    tslam.replay(x, v, t, TCFG, device="cpu")
    f, m = TCFG.feature, TCFG.mapping
    per_scan = 2 + f.odom_surf_iters + f.odom_corner_iters
    per_cycle = 1 + m.scan2map_iters
    assert 6 <= tdevice.sync_count() <= 6 * per_scan + per_cycle


def test_entry_points_refuse_to_fall_back_to_the_cpu(torch_run):
    (x, v, t), state, _ = torch_run
    if torch.cuda.is_available():            # decided inside the test
        pytest.skip("a CUDA device is present")
    for call in (lambda: tslam.replay(x, v, t, TCFG),
                 lambda: tslam.replay(x, v, t, TCFG, device=None),
                 lambda: tslam.replay_from(state, x, v, t, TCFG),
                 lambda: tslam.init_state(TCFG)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_odometry_only_runs_no_mapping(sequence):
    import dataclasses
    scans, _, times = sequence
    cfg = TCFG.replace(pipeline=dataclasses.replace(TCFG.pipeline,
                                                    odometry_only=True))
    x, v, t = pack_sequence(scans[:6], times[:6], cfg, device="cpu")
    state, outs = tslam.replay(x, v, t, cfg, device="cpu")
    assert int(state.mapping.meta.kf_count) == 0
    assert int(state.mapping.meta.cycle) == 0
    np.testing.assert_array_equal(tnp(outs["fused"]), tnp(outs["odom"]))
    assert np.abs(tnp(outs["odom"][-1, 3:])).max() > 0.1     # it moved


@pytest.mark.parametrize("where", [0, 4, 6])
def test_empty_scan_does_not_nan(sequence, where):
    """An empty sweep as the first scan, on a mapping scan and after one."""
    scans, _, times = sequence
    scans = [s if i != where else np.zeros((0, 3), np.float32)
             for i, s in enumerate(scans[:8])]
    x, v, t = pack_sequence(scans, times[:8], TCFG, device="cpu")
    assert not bool(v[where].any())
    state, outs = tslam.replay(x, v, t, TCFG, device="cpu")
    for name in ("odom", "fused", "mapped"):
        assert torch.isfinite(outs[name]).all(), name
    assert torch.isfinite(state.mapping.meta.kf_pose).all()

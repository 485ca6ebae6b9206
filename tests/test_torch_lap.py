"""The port over whole loop laps on the CPU: loop closure fires and bounds the
drift, and the thresholded re-solve (an accepted closure whose ICP correction
stays under ``loop_relin_trans`` / ``loop_relin_rot_deg`` keeps its factor but
skips the re-solve) keeps the trajectory of the always-re-solve run.

The laps are those of the JAX package's ``tests/test_loop_e2e.py`` (seed 33)
and ``tests/test_reference_parity.py::test_parity_loop_on_second_seed``
(seed 55), on ``small_loop_cfg`` as the port reads it
(``torch_port_util.LAPS``).  Each lap is replayed once for the module.

Two slow tests hold the port against the JAX package and against the port's
copy of the reference oracle on the same laps; in one process, the first
shares ``test_loop_e2e._loop_run`` with the JAX package's loop tests:

    python -m pytest tests/ -q -m slow -n 0 -k "loop_e2e or torch_lap"
"""

import functools

import numpy as np
import pytest

from torch_port_util import (LAPS, ate_vs_truth, lap_sequence, port_cfg,
                             replay_drive)


@functools.lru_cache(maxsize=None)
def _lap(name):
    """The port's replay of ``LAPS[name]``, loop closure on, thresholded
    re-solve (the configuration's own)."""
    return replay_drive(*LAPS[name])


@pytest.mark.parametrize("lap", list(LAPS))
def test_loop_closure_fires_and_bounds_drift(lap):
    """``test_loop_e2e.py::test_loop_closure_fires_and_bounds_drift``'s
    checks and bounds, on both laps.  The ATE bound of 0.9 m is that test's
    (seed 33); ``test_parity_loop_on_second_seed`` bounds the seed-55 lap by
    the oracle's ATE instead, which ``test_seed55_lap_at_most_the_oracles``
    holds under ``-m slow``."""
    final, outs, gt = _lap(lap)
    meta = final.mapping.meta
    kf = int(meta.kf_count)
    factors = int(meta.factor_count)
    assert kf > 10
    # at least one loop factor beyond the odometry chain (chain = kf-1)
    assert factors >= kf, (kf, factors)
    # loop_history_cap did not censor the ICP target
    assert int(meta.map_sat) == 0

    fused = outs["fused"]
    assert np.isfinite(fused).all()
    m = ate_vs_truth(fused, gt)
    assert m["rmse"] < 0.9, m


def test_thresholded_relinearization_matches_always_relin():
    """A skipped re-solve is subsumed by the next one (the factor enters the
    graph either way), so the thresholded run's trajectory stays within
    kNN tie-break noise of the run that re-solves on every closure."""
    final, outs, gt = _lap("seed33-r2.2")
    # negative threshold: every accepted closure re-solves
    final_a, outs_a, _ = replay_drive(*LAPS["seed33-r2.2"],
                                      loop_relin_trans=-1.0)

    for state in (final, final_a):
        assert int(state.mapping.meta.factor_count) >= \
            int(state.mapping.meta.kf_count)

    # loop_diag slot 7: +1 = accepted and re-solved, 0 = accepted, skipped
    diag = outs["loop_diag"]
    accepted = diag[:, 1] > 0.5
    assert bool(np.any(accepted & (diag[:, 7] < 0.5))), \
        "no closure exercised the skip branch"
    diag_a = outs_a["loop_diag"]
    acc_a = diag_a[:, 1] > 0.5
    assert bool(np.all(diag_a[acc_a, 7] > 0.5))

    m_thr = ate_vs_truth(outs["fused"], gt)
    m_alw = ate_vs_truth(outs_a["fused"], gt)
    assert abs(m_thr["rmse"] - m_alw["rmse"]) < 0.15, (m_thr, m_alw)
    assert m_alw["rmse"] < 0.9, m_alw


@pytest.mark.slow
def test_seed33_lap_matches_jax():
    """The port and the JAX package replay the same seed-33 lap (slow: the
    JAX replay, ``test_loop_e2e._loop_run``, takes ~450 s on the CPU): the
    same keyframes and factors, closures accepted and re-solved at the same
    scans, and the ATEs within 0.05 m, the slack of
    ``test_torch_slam.py::test_replay_matches_jax`` (the two read 0.482 and
    0.485 m on the 8-core build machine)."""
    from tests.test_loop_e2e import _loop_run

    _, _, jgt, jfinal, jouts = _loop_run()
    final, outs, gt = _lap("seed33-r2.2")
    np.testing.assert_array_equal(gt, jgt)          # the same lap

    got = (int(final.mapping.meta.kf_count),
           int(final.mapping.meta.factor_count))
    want = (int(jfinal.mapping.store.count), int(jfinal.mapping.factor_count))
    assert got == want, (got, want)
    # loop_diag slot 1: accepted; slot 7: re-solved
    diag, jdiag = outs["loop_diag"], np.asarray(jouts["loop_diag"])
    for slot in (1, 7):
        np.testing.assert_array_equal(diag[:, slot] > 0.5,
                                      jdiag[:, slot] > 0.5, err_msg=slot)
    m = ate_vs_truth(outs["fused"], gt)
    jm = ate_vs_truth(np.asarray(jouts["fused"]), gt)
    print(f"\nseed 33: port {got} keyframes / factors, ATE "
          f"{m['rmse']:.4f} m   JAX {want}, {jm['rmse']:.4f} m")
    assert abs(m["rmse"] - jm["rmse"]) < 0.05, (m, jm)


@pytest.mark.slow
def test_seed55_lap_at_most_the_oracles():
    """``test_parity_loop_on_second_seed`` on the port: the port's copy of
    the reference oracle closes the seed-55 lap too, and the port's ATE is
    at most the oracle's x 1.15 + 0.02, that test's bound (slow: with the
    NumPy oracle's replay the test takes two minutes on the CPU)."""
    from lego_loam_tpu_torch.eval.reference_oracle import ReferenceOracle
    from tests.test_loop_e2e import small_loop_cfg

    scans, gt, times = lap_sequence(*LAPS["seed55-r1.7"])
    final, outs, _ = _lap("seed55-r1.7")
    o = ReferenceOracle(port_cfg(small_loop_cfg()))
    for pts, t in zip(scans, times):
        o.process(pts, float(t))
    oracle_fused = np.asarray(o.fused_poses)

    assert len(o.loop_factors) >= 1
    assert int(final.mapping.meta.factor_count) >= \
        int(final.mapping.meta.kf_count)
    assert np.isfinite(oracle_fused).all()
    m_port = ate_vs_truth(outs["fused"], gt)
    m_orc = ate_vs_truth(oracle_fused, gt)
    print(f"\nseed 55: port ATE {m_port['rmse']:.4f} m   oracle ATE "
          f"{m_orc['rmse']:.4f} m   oracle loops {len(o.loop_factors)}")
    assert m_port["rmse"] <= m_orc["rmse"] * 1.15 + 0.02, (m_port, m_orc)

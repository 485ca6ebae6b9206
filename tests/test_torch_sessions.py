"""The synthetic sequences ``chip_smoke.py`` makes in worker processes, held
to the generators they copy: the two sessions of
``benchmarks/multi_session.py::make_two_sessions`` (config 5 of
``BASELINE.json``), which the JAX package's ``MULTISESSION_r05.json`` was
taken on — a short pair, so the stamp gap, the shifted trajectory and the
per-scan seeds of both sessions are checked."""

import importlib.util
import os

import numpy as np

import chip_smoke
from lego_loam_tpu.core.config import vlp16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _multi_session():
    spec = importlib.util.spec_from_file_location(
        "multi_session", os.path.join(ROOT, "benchmarks", "multi_session.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sessions_equal_the_benchmarks():
    n1, n2 = 2, 2
    (s1, gt1, t1), (s2, gt2, t2) = _multi_session().make_two_sessions(
        n1, n2, vlp16(), seed=chip_smoke.SESSION_SEED)
    got = chip_smoke.session_chunk(0, n1 + n2, n1, n2)
    for k, (a, b) in enumerate(zip(got, s1 + s2)):
        assert np.array_equal(a, b, equal_nan=True), k
    gt, times, _, _ = chip_smoke.session_trajectory(n1, n2)
    np.testing.assert_array_equal(gt, np.concatenate([gt1, gt2]))
    np.testing.assert_array_equal(times, np.concatenate([t1, t2]))
    assert times[n1] - times[n1 - 1] > chip_smoke.SESSION_GAP_S

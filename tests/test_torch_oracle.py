"""The port's copy of the reference oracle (``eval/reference_oracle.py``):
its ``run_oracle`` equals the JAX package's bit for bit, and the port's
``replay`` is held to it as ``tests/test_reference_parity.py`` holds the
JAX package — ATE at most the oracle's × 1.15 + 0.02 m on the loop-off
``_fast_cfg`` geometry.  The oracle costs about 1.3 s a scan on the CPU, so
the sequences are short (8 scans with one mapping cycle for the copy, 20
for the parity, which is ``test_parity_loop_off``'s first case)."""

import numpy as np

from lego_loam_tpu.eval import reference_oracle as jorc
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu_torch.eval import reference_oracle as torc
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.pipeline.slam import replay

from tests.test_reference_parity import _fast_cfg
from torch_port_util import ate_vs_truth, port_cfg


def test_oracle_copy_equals_original():
    jcfg = _fast_cfg()
    scans, _gt, times = make_sequence(8, jcfg, seed=11, noise=0.01,
                                      radius=6.0, speed=1.2)
    got = torc.run_oracle(scans, times, port_cfg(jcfg))
    ref = jorc.run_oracle(scans, times, jcfg)
    assert got.shape == (8, 6) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_port_ate_at_most_the_oracles():
    jcfg = _fast_cfg()
    cfg = port_cfg(jcfg)
    n = 20
    scans, gt, times = make_sequence(n, jcfg, seed=11, noise=0.01,
                                     radius=6.0, speed=1.2)
    xyz, valid, t = pack_sequence(scans, times, cfg, device="cpu")
    _, outs = replay(xyz, valid, t, cfg, device="cpu")
    fused = outs["fused"].numpy()
    oracle_fused = torc.run_oracle(scans, times, cfg)
    m_port = ate_vs_truth(fused, gt)
    m_orc = ate_vs_truth(oracle_fused, gt)
    assert np.isfinite(fused).all() and np.isfinite(oracle_fused).all()
    # the slack of tests/test_reference_parity.py::test_parity_loop_off
    assert m_port["rmse"] <= m_orc["rmse"] * 1.15 + 0.02, (m_port, m_orc)

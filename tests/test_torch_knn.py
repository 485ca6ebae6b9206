"""The port's 5-NN plain version and distance matrix vs the JAX package's
exact brute-force oracle, on the CPU.  (The CUDA kernel itself has no
interpret mode; ``chip_smoke.py`` holds it against this plain version on
the card with the same criteria.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.match import bruteforce as jbf
from lego_loam_tpu_torch.match import bruteforce as tbf
from lego_loam_tpu_torch.match import cuda_knn
from torch_port_util import tnp


@pytest.fixture(scope="module")
def case():
    """The case of tests/test_pallas_knn.py: production-scale M, points
    200 m from the origin, 10 % invalid on both sides."""
    rng = np.random.default_rng(3)
    Q, M = 300, 16384
    q = (rng.uniform(-30, 30, (Q, 3)) + 200.0).astype(np.float32)
    c = (rng.uniform(-30, 30, (M, 3)) + 200.0).astype(np.float32)
    qv = rng.random(Q) > 0.1
    cv = rng.random(M) > 0.1
    return q, qv, c, cv


@pytest.fixture(scope="module")
def oracle(case):
    q, qv, c, cv = case
    idx, d2 = jbf.knn(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(c),
                      jnp.asarray(cv), k=6)
    return np.asarray(idx), np.asarray(d2)


def _as_torch(case):
    return tuple(torch.from_numpy(a) for a in case)


def test_knn5_torch_matches_oracle(case, oracle):
    q, qv, c, cv = case
    idx_o, d2_o = oracle
    idx, d2 = cuda_knn.knn5(*_as_torch(case))      # CPU tensors ⇒ plain
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    idx, d2 = tnp(idx), tnp(d2)

    assert np.all(d2[~qv] > 1e30)                  # invalid queries: +inf
    # ... but their idx are still five distinct real neighbours
    assert np.all(np.diff(np.sort(idx[~qv], axis=1), axis=1) > 0)
    rows = np.nonzero(qv)[0]
    assert np.all(cv[idx[rows]])                   # only valid candidates
    np.testing.assert_array_equal(idx[rows, 0], idx_o[rows, 0])  # nearest
    # identical 5-sets wherever the 5th and 6th neighbours are not a
    # near-tie of the ranking matrix (its error is ~1e-4 m² here)
    clear = rows[(d2_o[rows, 5] - d2_o[rows, 4]) > 1e-4]
    assert len(clear) > 0.9 * len(rows)
    for i in clear:
        assert set(idx[i]) == set(idx_o[i, :5]), i
    # distances are the exact difference-first ones, ascending
    ref = ((c[idx[rows]].astype(np.float64)
            - q[rows, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2[rows], ref, rtol=1e-5)
    assert np.all(np.diff(d2[rows], axis=1) >= 0)


def test_knn_and_knn_chunked_match_jax(case, oracle):
    idx_o, d2_o = oracle
    q, qv, c, cv = case
    tq, tqv, tc, tcv = _as_torch(case)
    idx, d2 = tbf.knn(tq, tqv, tc, tcv, k=6)
    rows = np.nonzero(qv)[0]
    clear = rows[np.min(np.diff(d2_o[rows], axis=1), axis=1) > 1e-4]
    np.testing.assert_array_equal(tnp(idx)[clear], idx_o[clear])
    np.testing.assert_allclose(tnp(d2)[rows], d2_o[rows], atol=2e-3)
    idx_c, d2_c = tbf.knn_chunked(tq, tqv, tc, tcv, k=5)
    np.testing.assert_array_equal(tnp(idx_c)[clear], idx_o[clear, :5])
    assert np.all(tnp(d2_c)[~qv] > 1e30)


@pytest.mark.parametrize("off", [0.0, 100.0, 400.0])
def test_pairwise_sqdist_far_from_origin(off):
    """The recentred float32 distance matrix stays accurate at world-frame
    offsets where the naive norm expansion loses hundreds of m²."""
    rng = np.random.default_rng(0)
    q = (rng.uniform(-30, 30, (128, 3)) + off).astype(np.float32)
    c = (rng.uniform(-30, 30, (1024, 3)) + off).astype(np.float32)
    d2 = tnp(tbf.pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(c)))
    ref = ((q[:, None, :].astype(np.float64) - c[None, :, :]) ** 2).sum(-1)
    assert np.abs(d2 - ref).max() < 0.05
    dj = np.asarray(jbf.pairwise_sqdist(jnp.asarray(q), jnp.asarray(c)))
    assert np.abs(d2 - dj).max() < 0.01


def test_knn5_fewer_than_five_valid_candidates():
    rng = np.random.default_rng(1)
    q = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    c = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    cv = np.zeros(64, bool)
    cv[[3, 17, 40]] = True
    qv = np.ones(16, bool)
    idx, d2 = cuda_knn.knn5(*_as_torch((q, qv, c, cv)))
    idx, d2 = tnp(idx), tnp(d2)
    assert np.all(d2[:, 3:] >= 1e30) and np.all(idx[:, 3:] == 0)
    assert np.all(d2[:, :3] < 1e3)
    for i in range(16):
        assert set(idx[i, :3]) == {3, 17, 40}
    # no valid candidate at all
    idx, d2 = cuda_knn.knn5(*_as_torch((q, qv, c, np.zeros(64, bool))))
    assert np.all(tnp(d2) >= 1e30) and np.all(tnp(idx) == 0)


def test_knn5_wrapper_dispatch_and_checks():
    """CPU tensors never reach the kernel (no launch counted); the kernel
    wrapper raises on tensors it cannot take instead of falling back."""
    q = torch.zeros((4, 3))
    c = torch.ones((8, 3))
    before = cuda_knn.launch_count
    cuda_knn.knn5(q, torch.ones(4, dtype=torch.bool), c,
                  torch.ones(8, dtype=torch.bool))
    assert cuda_knn.launch_count == before
    with pytest.raises(ValueError):
        cuda_knn.knn5_cuda(q, torch.ones(4, dtype=torch.bool), c,
                           torch.ones(8, dtype=torch.bool))
    assert cuda_knn._splits(8192, 32768) * 64 >= cuda_knn._TARGET_BLOCKS
    assert cuda_knn._splits(2048, 16384) == 16
    assert cuda_knn._splits(100, 500) == 1

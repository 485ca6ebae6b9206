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
    with pytest.raises(ValueError):
        cuda_knn.knn5_cuda_grouped([])                    # 1 to 4 problems
    # the two main-path searches are cut into enough blocks for the card
    for Q, M in ((1024, 16384), (2048, 32768)):
        assert cuda_knn.launch_geometry(Q, M, 132, QUERY_BLOCK).blocks >= 132
    assert cuda_knn.launch_geometry(100, 500, 132, QUERY_BLOCK).splits == 1


QUERY_BLOCK = 128   # queries a block of csrc/knn5.cu (knn5_query_block())


@pytest.mark.parametrize("M", [1, 5000, 16384, 32768])
@pytest.mark.parametrize("Q", [1, 127, 1000, 1024, 2048, 8192])
def test_launch_geometry(Q, M):
    """The host-side cut of one search into blocks: slices cover [0, M)
    exactly once and none is empty, a slice starts on the 16-candidate grid
    of the kernel's copies, there are enough blocks for 132 SMs where Q * M
    allows, and the scratch stays under the 32-bit offset check."""
    g = cuda_knn.launch_geometry(Q, M, 132, QUERY_BLOCK)
    assert g.qblocks == -(-Q // QUERY_BLOCK)
    assert g.qblocks * QUERY_BLOCK >= Q
    assert g.splits >= 1 and g.chunk % cuda_knn._SLICE_ALIGN == 0
    assert g.splits * g.chunk >= M                       # covers [0, M)
    assert (g.splits - 1) * g.chunk < M                  # last slice not empty
    assert g.splits <= cuda_knn._MAX_SPLITS
    if M >= 2 * cuda_knn._MIN_SLICE:
        assert g.chunk >= cuda_knn._MIN_SLICE
    # enough blocks for every SM unless the slices would get too short or
    # too many
    most = min(cuda_knn._MAX_SPLITS, max(1, M // cuda_knn._MIN_SLICE))
    if g.qblocks * most >= 132:
        assert g.blocks >= 132, g
    assert g.blocks == g.qblocks * g.splits
    assert g.scratch_entries == (0 if g.splits == 1 else
                                 g.blocks * 6 * QUERY_BLOCK)
    assert g.scratch_entries < 2 ** 31


def test_knn5_grouped_equals_single_calls(case):
    """The grouped entry point on CPU tensors: same lists as single calls,
    problem by problem, shapes mixed."""
    q, qv, c, cv = _as_torch(case)
    rng = np.random.default_rng(5)
    q2 = torch.from_numpy(rng.uniform(-5, 5, (70, 3)).astype(np.float32))
    c2 = torch.from_numpy(rng.uniform(-5, 5, (900, 3)).astype(np.float32))
    problems = [(q, qv, c, cv),
                (q2, torch.ones(70, dtype=torch.bool), c2,
                 torch.from_numpy(rng.random(900) > 0.3)),
                (q[:40], qv[:40], c[:4000], cv[:4000])]
    before = cuda_knn.launch_count
    grouped = cuda_knn.knn5_grouped(problems)
    assert cuda_knn.launch_count == before and len(grouped) == 3
    for (idx, d2), p in zip(grouped, problems):
        ridx, rd2 = cuda_knn.knn5(*p)
        assert idx.dtype == torch.int32 and idx.shape == (p[0].shape[0], 5)
        assert torch.equal(idx, ridx) and torch.equal(d2, rd2)

"""PyTorch port vs JAX package: the pose-graph solver (``graph/posegraph.py``).

The same graph — a 64-node drifting square chain with two loop factors, made
from a seed with NumPy — goes through both solvers.  Tolerances: residuals
and Jacobian blocks 1e-4 relative to their scale (float32, another
summation order, forward-mode AD on both sides); solved poses 1e-4 (the PCG
stops at a 1e-6 relative residual on both sides, so the answers agree far
inside that); PCG iteration counts within one (the preconditioner's block
inverses are an LU here and an unrolled Cholesky there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.graph import posegraph as jpg
from lego_loam_tpu_torch.graph import posegraph as tpg
from torch_port_util import tnp, to_torch

K = 64
CAP = 128
ODOM_W = np.asarray([1e3, 1e3, 1e3, 1e2, 1e2, 1e2], np.float32)
LOOP_W = np.asarray([300.0, 300.0, 300.0, 100.0, 100.0, 100.0], np.float32)


def _square(n_nodes=K, drift_yaw=0.004, noise=0.01, seed=0):
    """Ground-truth square path of ``n_nodes`` poses and its odometry with a
    yaw drift and noise; returns (gt (n,6), measurements (n-1,6))."""
    rng = np.random.default_rng(seed)
    side = n_nodes // 4
    gt = [np.zeros(6, np.float32)]
    meas = []
    for k in range(n_nodes - 1):
        turn = (k % side == side - 1)
        z = np.array([0, 0, np.pi / 2 if turn else 0.0, 1.0, 0, 0],
                     np.float32)
        gt.append(np.asarray(jse3.compose(jnp.asarray(gt[-1]),
                                          jnp.asarray(z))))
        zm = z.copy()
        zm[2] += drift_yaw + rng.normal(0, noise * 0.1)
        zm[3:5] += rng.normal(0, noise, 2)
        meas.append(zm)
    return np.asarray(gt, np.float32), np.asarray(meas, np.float32)


@pytest.fixture(scope="module")
def problem():
    """(JAX graph, initial poses, node count): the odometry chain plus two
    loop factors from the true relative poses."""
    gt, meas = _square()
    g = jpg.empty_graph(CAP)
    count = jnp.int32(0)
    poses = np.zeros((K, 6), np.float32)
    for k, z in enumerate(meas):
        poses[k + 1] = np.asarray(jse3.compose(jnp.asarray(poses[k]),
                                               jnp.asarray(z)))
        g, count = jpg.add_factor(g, count, jnp.int32(k), jnp.int32(k + 1),
                                  jnp.asarray(z), jnp.asarray(ODOM_W))
    for i, j in ((K - 1, 0), (K - 2, 16)):
        z = jse3.relative(jnp.asarray(gt[i]), jnp.asarray(gt[j]))
        g, count = jpg.add_factor(g, count, jnp.int32(i), jnp.int32(j), z,
                                  jnp.asarray(LOOP_W))
    g = g.replace(prior=jnp.zeros((6,), jnp.float32))
    return g, poses, K, gt


@pytest.fixture(scope="module")
def jax_solution(problem):
    g, poses, n, _ = problem
    out, iters = jpg.optimize_poses(jnp.asarray(poses), jnp.int32(n), g,
                                    gn_iters=3, pcg_iters=64,
                                    return_iters=True)
    return np.asarray(out), np.asarray(iters)


def test_between_residual_and_blocks_match_jax(problem):
    g, poses, _, _ = problem
    rng = np.random.default_rng(1)
    p = (poses + rng.normal(0, 0.05, poses.shape)).astype(np.float32)
    jr, jAi, jAj = jax.jit(jpg._factor_blocks)(jnp.asarray(p), g)
    tg = to_torch("FactorGraph", g)
    r, Ai, Aj = tpg._factor_blocks(torch.from_numpy(p), tg,
                                   tg.i.long(), tg.j.long())
    for got, ref in ((r, jr), (Ai, jAi), (Aj, jAj)):
        assert got.dtype == torch.float32
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(tnp(got), ref, atol=1e-4 * scale)
    # zero at the truth
    a, b = p[3], p[40]
    z = jse3.relative(jnp.asarray(a), jnp.asarray(b))
    res = tpg.between_residual(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(tnp(res), np.zeros(6), atol=1e-5)


@jax.jit
def _jax_chain_solve(g, Ai, Aj, D, n, rhs):
    return jpg.chain_preconditioner(g, Ai, Aj, D, n, K)(rhs)


@pytest.mark.parametrize("n", [64, 50])
def test_cyclic_reduction_inverts_the_chain(problem, n):
    """The preconditioner is the exact inverse of the chain part of H:
    applied to H_chain·x it gives x back (dense float64 reference), for a
    power-of-two node count and a padded one, and agrees with the JAX
    package's factorization on the same blocks."""
    g, poses, _, _ = problem
    tg = to_torch("FactorGraph", g)
    gi, gj = tg.i.long(), tg.j.long()
    P = torch.from_numpy(poses)
    _, Ai, Aj = tpg._factor_blocks(P, tg, gi, gj)
    w2 = tg.prior_weight ** 2
    D = tpg._block_diag(gi, gj, Ai, Aj, K)
    D[0] += torch.diag(w2)
    D = D + 1e-6 * torch.eye(6)
    sub = tpg._chain_subdiag(tg, Ai, Aj, K)
    M_inv = tpg.chain_preconditioner(sub, D, torch.tensor(n), K)
    # dense chain matrix of the first n nodes, float64
    A = sub.double()
    T = torch.zeros((6 * n, 6 * n), dtype=torch.float64)
    for k in range(n):
        T[6 * k:6 * k + 6, 6 * k:6 * k + 6] = D[k].double()
        if k:
            T[6 * k:6 * k + 6, 6 * k - 6:6 * k] = A[k]
            T[6 * k - 6:6 * k, 6 * k:6 * k + 6] = A[k].T
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (K, 6))
    x[n:] = 0.0
    b = (T @ torch.from_numpy(x[:n].reshape(-1))).reshape(n, 6)
    rhs = torch.zeros((K, 6), dtype=torch.float32)
    rhs[:n] = b.float()
    got = tnp(M_inv(rhs))
    np.testing.assert_allclose(got, x, atol=2e-3 * np.abs(x).max())
    jAi, jAj = jnp.asarray(tnp(Ai)), jnp.asarray(tnp(Aj))
    ref = np.asarray(_jax_chain_solve(g, jAi, jAj, jnp.asarray(tnp(D)),
                                      jnp.int32(n), jnp.asarray(tnp(rhs))))
    np.testing.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max())


def test_optimize_poses_matches_jax(problem, jax_solution):
    g, poses, n, gt = problem
    ref, ref_iters = jax_solution
    tg = to_torch("FactorGraph", g)
    got, iters = tpg.optimize_poses(torch.from_numpy(poses), torch.tensor(n),
                                    tg, gn_iters=3, pcg_iters=64,
                                    return_iters=True)
    got = tnp(got)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert len(iters) == 3
    assert all(abs(a - int(b)) <= 1 for a, b in zip(iters, ref_iters)), \
        (iters, ref_iters)
    assert 0 < iters[0] < 64
    # the loop factors pulled the drifted chain back toward the truth
    before = np.abs(poses[:n, 3:5] - gt[:, 3:5]).max()
    after = np.abs(got[:n, 3:5] - gt[:, 3:5]).max()
    assert after < 0.5 * before, (before, after)


def test_optimize_poses_freezes_nodes_past_the_count(problem):
    """Nodes ≥ node_count are not touched, and the solve over the first 40
    nodes (chain only: the loop factors' ends are out of range and their
    rows carry weight zero) equals the JAX package's."""
    g, poses, _, _ = problem
    keep = np.zeros(CAP, bool)
    keep[:39] = True
    gj = g.replace(valid=jnp.asarray(keep))
    ref, _ = jpg.optimize_poses(jnp.asarray(poses), jnp.int32(40), gj,
                                gn_iters=3, pcg_iters=64, return_iters=True)
    ref = np.asarray(ref)
    tg = to_torch("FactorGraph", gj)
    got = tnp(tpg.optimize_poses(torch.from_numpy(poses), torch.tensor(40),
                                 tg, gn_iters=3, pcg_iters=64))
    np.testing.assert_array_equal(got[40:], poses[40:])
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # without loop factors the solution is the composed odometry
    np.testing.assert_allclose(got[:40], poses[:40], atol=5e-3)

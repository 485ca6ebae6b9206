"""Pose-graph storage and optimisation — the iSAM2 replacement.

The reference hands keyframe poses to gtsam iSAM2 (PriorFactor +
BetweenFactor chain + loop BetweenFactors, ``mapOptmization.cpp:1335-1478``,
``:837-850``) and reads corrected poses back after loop closures
(``correctPoses`` :1481-1511).  Without loop factors the chain's exact MAP
solution is the composed odometry, so the solver runs only when a loop
factor arrives.

The solver is the JAX package's: batched Gauss-Newton over all keyframe
poses at once.  Per-factor 6-vector residuals and 6×6 Jacobian blocks come
from one vmapped forward-mode derivative (``torch.func``); the sparse normal
equations H δ = −g are solved matrix-free with preconditioned conjugate
gradient (H·x = two gathers, four batched 6×6 products, one sum into the
nodes).
The preconditioner is the EXACT inverse of the block-tridiagonal chain part
of H, factored by parallel block cyclic reduction (:func:`_cr_factor`,
log₂K levels of batched 6×6 products): H differs from the chain only by
the low-rank loop factors, so PCG converges in a handful of iterations
whatever the chain length.

Port notes: blocks are kept as (K, 6, 6) (PyTorch's batched-matrix idiom;
the JAX package keeps them batch-minor (6, 6, K) for the TPU's lanes), and
products are ``torch.matmul`` in float32 (TF32 is off for the whole
package).  The block inverses of the cyclic reduction are
``torch.linalg.inv_ex``, which checks nothing and so never waits for the
device (the JAX package unrolls a Cholesky inverse); the blocks are SPD, and
the inverse only preconditions, so its rounding moves the PCG iteration
count, not the solution.  The PCG's early exit on the relative residual is
a Python loop with one counted host read per iteration
(``core/device.py::host_bool``): at most ``pcg_iters`` + 1 per Gauss-Newton
step.  Every sum of factor quantities into nodes runs in an order fixed by
the graph (``core/segsum.py``, one plan a solve), so a solve on the card
repeats bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import se3
from ..core.device import DeviceLike, host_bool, resolve_device
from ..core.segsum import Segments, segment_sum, segments
from ..core.types import Container

Tensor = torch.Tensor


@dataclasses.dataclass
class FactorGraph(Container):
    """Fixed-capacity factor storage.

    Between factors i→j carry measurement z (6,) = pose of j in i's frame
    and a per-component weight (1/σ).  The odometry chain is factors
    (k−1→k); loop factors append after them.
    """
    i: Tensor          # (F,) int32
    j: Tensor          # (F,) int32
    z: Tensor          # (F, 6)
    weight: Tensor     # (F, 6)
    valid: Tensor      # (F,)
    prior: Tensor      # (6,) pose anchor for node 0
    prior_weight: Tensor  # (6,)


def empty_graph(capacity: int, device: DeviceLike = None) -> FactorGraph:
    device = resolve_device(device)
    return FactorGraph(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        z=torch.zeros((capacity, 6), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity, 6), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        prior=torch.zeros((6,), dtype=torch.float32, device=device),
        prior_weight=torch.full((6,), 1e3, dtype=torch.float32,
                                device=device))


def add_factor(g: FactorGraph, count: Tensor, i: Tensor, j: Tensor, z: Tensor,
               weight: Tensor, enable: Optional[Tensor] = None):
    """Append one factor at slot ``count`` (no-op when full, or when the
    optional () bool ``enable`` is False).  Returns (new graph, new count);
    the given graph is not written."""
    cap = g.i.shape[0]
    slot = torch.clamp(count, max=cap - 1).reshape(1).to(torch.int64)
    ok = count < cap
    if enable is not None:
        ok = ok & enable

    def put(arr, new):
        new = torch.as_tensor(new, dtype=arr.dtype, device=arr.device)
        old = arr.index_select(0, slot)
        return arr.index_copy(0, slot, torch.where(ok, new[None], old))

    g = g.replace(
        i=put(g.i, i), j=put(g.j, j), z=put(g.z, z),
        # valid = ``ok`` where written (True): a host scalar would be a copy
        # to the device, which a CUDA-graph capture cannot hold
        weight=put(g.weight, weight), valid=put(g.valid, ok))
    return g, count + ok.to(count.dtype)


def between_residual(pi: Tensor, pj: Tensor, z: Tensor) -> Tensor:
    """Geometric between-factor error: [so3_log(Rz⁻¹ Ri⁻¹ Rj),
    Rz⁻¹(Ri⁻¹(t_j − t_i) − t_z)] — exact on the manifold even for the large
    errors a fresh loop closure introduces.  Batched over leading dims."""
    Ri = se3.rpy_to_matrix(pi[..., :3])
    Rj = se3.rpy_to_matrix(pj[..., :3])
    Rz = se3.rpy_to_matrix(z[..., :3])
    RiT = Ri.transpose(-1, -2)
    RzT = Rz.transpose(-1, -2)
    R_err = RzT @ (RiT @ Rj)
    t_rel = (RiT @ (pj[..., 3:] - pi[..., 3:])[..., None])[..., 0]
    t_err = (RzT @ (t_rel - z[..., 3:])[..., None])[..., 0]
    return torch.cat([se3.so3_log(R_err), t_err], -1)


def _residual_jac(pi: Tensor, pj: Tensor, z: Tensor):
    """∂r/∂pi and ∂r/∂pj, (F, 6, 6) each: forward-mode derivatives of the
    BATCHED residual along the 12 unit tangents, one ``vmap``-ed ``jvp``.
    (Differentiating a per-factor function instead, ``vmap(jacfwd(...))``,
    puts 0-dim intermediates under forward AD, which some PyTorch versions
    promote to float64.)"""
    F = pi.shape[0]
    basis = torch.eye(12, dtype=pi.dtype, device=pi.device)[:, None, :] \
        .expand(12, F, 12)

    def along(t):
        return torch.func.jvp(lambda a, b: between_residual(a, b, z),
                              (pi, pj), (t[..., :6], t[..., 6:]))[1]

    J = torch.func.vmap(along)(basis).permute(1, 2, 0)       # (F, 6, 12)
    return J[..., :6], J[..., 6:]


def _factor_blocks(poses: Tensor, g: FactorGraph, gi: Tensor, gj: Tensor):
    """Residuals + Jacobian blocks for every factor, batched.

    Returns (r (F,6), Ai (F,6,6) = ∂r/∂pose_i, Aj (F,6,6) = ∂r/∂pose_j),
    already weighted (invalid factors have zero rows)."""
    pi = poses[gi]
    pj = poses[gj]
    r = between_residual(pi, pj, g.z)
    Ai, Aj = _residual_jac(pi, pj, g.z)
    m = g.weight * g.valid.to(g.weight.dtype)[:, None]
    return r * m, Ai * m[:, :, None], Aj * m[:, :, None]


def _bmv(a: Tensor, v: Tensor) -> Tensor:
    """(…, i, k) @ (…, k)."""
    return (a @ v[..., None])[..., 0]


def _bmv_t(a: Tensor, v: Tensor) -> Tensor:
    """aᵀ v: (…, k, i) @ (…, k)."""
    return (a.transpose(-1, -2) @ v[..., None])[..., 0]


def _bmm_tn(a: Tensor, b: Tensor) -> Tensor:
    """aᵀ b over the last two dims."""
    return a.transpose(-1, -2) @ b


def _incidence(gi: Tensor, gj: Tensor, K: int) -> Segments:
    """The sum plan of a factor quantity into its two nodes: rows
    ``[by i; by j]`` into K slots (fixed for a whole solve)."""
    return segments(torch.cat([gi, gj]), K)


def _node_sum(vi: Tensor, vj: Tensor, plan: Segments) -> Tensor:
    """Σ over factors of ``vi`` into node i and ``vj`` into node j, in the
    order fixed by ``plan`` (:func:`_incidence`)."""
    return segment_sum(torch.cat([vi, vj]), plan)


def _hvp(x: Tensor, gi: Tensor, gj: Tensor, Ai: Tensor, Aj: Tensor,
         plan: Segments) -> Tensor:
    """Σ_f [Ai Aj]ᵀ[Ai Aj]·x over the given factors — matrix-free (the
    prior is added by the caller, once).  ``plan``: :func:`_incidence` of
    (gi, gj)."""
    u = _bmv(Ai, x[gi]) + _bmv(Aj, x[gj])
    return _node_sum(_bmv_t(Ai, u), _bmv_t(Aj, u), plan)


def _block_diag(gi: Tensor, gj: Tensor, Ai: Tensor, Aj: Tensor,
                K: int, plan: Optional[Segments] = None) -> Tensor:
    """The K diagonal 6×6 blocks of Σ_f [Ai Aj]ᵀ[Ai Aj] (no prior).
    ``plan``: :func:`_incidence` of (gi, gj, K), made here when not given."""
    if plan is None:
        plan = _incidence(gi, gj, K)
    return _node_sum(_bmm_tn(Ai, Ai), _bmm_tn(Aj, Aj), plan)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _chain_incidence(g: FactorGraph, K: int) -> Segments:
    """The sum plan of :func:`_chain_subdiag`: chain factors into the later
    node, every other factor into the dropped slot K."""
    up = g.j == g.i + 1          # factor (k−1 → k): H[j,i] += Ajᵀ Ai
    dn = g.i == g.j + 1          # factor (k → k−1): H[i,j] += Aiᵀ Aj
    return segments(torch.cat([torch.where(up, g.j, K),
                               torch.where(dn, g.i, K)]), K)


def _chain_subdiag(g: FactorGraph, Ai: Tensor, Aj: Tensor, K: int,
                   plan: Optional[Segments] = None) -> Tensor:
    """Sub-diagonal blocks of H restricted to chain factors:
    ``A[k] = H[k, k−1]`` summed over factors with ``|i−j| == 1``.

    Loop factors (|i−j| > 1) stay OUT — they are the low-rank part the PCG
    iterations absorb; invalid factors contribute zero blocks (their
    Jacobians are already masked in :func:`_factor_blocks`).  ``plan``:
    :func:`_chain_incidence` of (g, K), made here when not given."""
    if plan is None:
        plan = _chain_incidence(g, K)
    return _node_sum(_bmm_tn(Aj, Ai), _bmm_tn(Ai, Aj), plan)


def _inv6(B: Tensor) -> Tensor:
    """Inverse of SPD 6×6 blocks; no error check, so no host wait."""
    return torch.linalg.inv_ex(B).inverse


def _cr_factor(A: Tensor, B: Tensor):
    """Block cyclic-reduction factorization of the SPD block-tridiagonal
    matrix T (diagonal ``B`` (K,6,6), sub-diagonal ``A`` (K,6,6) with
    ``A[0] = 0``; super-diagonal = ``Aᵀ`` by symmetry).

    log₂K parallel levels, each eliminating the odd-indexed unknowns with
    batched 6×6 products — no sequential sweep over the keyframe axis.
    Returns (levels, B₁⁻¹) for :func:`_cr_solve`.  With the exact chain
    inverse as preconditioner the spectrum collapses to 1 + a low-rank
    loop-factor perturbation (block-Jacobi needs O(K) PCG iterations to
    carry a correction through the stiff chain)."""
    K = A.shape[0]
    K2 = _next_pow2(K)
    if K2 != K:
        A = torch.cat([A, A.new_zeros((K2 - K, 6, 6))])
        B = torch.cat([B, torch.eye(6, dtype=B.dtype, device=B.device)
                       .expand(K2 - K, 6, 6)])
    levels = []
    n = K2
    zero = A.new_zeros((1, 6, 6))
    while n > 1:
        Ae, Ao = A[0::2], A[1::2]                  # (n/2, 6, 6)
        Be, Bo = B[0::2], B[1::2]
        Bo_inv = _inv6(Bo)
        # P[m] = A_{2m} B_{2m−1}⁻¹ (0 for m = 0: A_0 = 0)
        P = torch.cat([zero, Ae[1:] @ Bo_inv[:-1]])
        # Q[m] = A_{2m+1}ᵀ B_{2m+1}⁻¹
        Q = _bmm_tn(Ao, Bo_inv)
        B = Be - P @ Ae.transpose(-1, -2) - Q @ Ao
        A = torch.cat([zero, -(P[1:] @ Ao[:-1])])
        levels.append((P, Q, Bo_inv, Ao, Ae))
        n //= 2
    return levels, _inv6(B)                        # (1, 6, 6)


def _cr_solve(levels, B1_inv: Tensor, r: Tensor) -> Tensor:
    """Apply T⁻¹ via the cyclic-reduction factorization: forward
    r-reduction down the levels, 1×1 block solve, back-substitution up."""
    K = r.shape[0]
    K2 = levels[0][0].shape[0] * 2 if levels else 1
    if K2 != K:
        r = torch.cat([r, r.new_zeros((K2 - K, 6))])
    zero = r.new_zeros((1, 6))
    ros = []
    for P, Q, Bo_inv, Ao, Ae in levels:
        re, ro = r[0::2], r[1::2]
        ros.append(ro)
        ro_prev = torch.cat([zero, ro[:-1]])
        r = re - _bmv(P, ro_prev) - _bmv(Q, ro)
    x = _bmv(B1_inv, r)                            # (1, 6)
    for (P, Q, Bo_inv, Ao, Ae), ro in zip(reversed(levels), reversed(ros)):
        xe = x                                     # (n/2, 6)
        xe_next = torch.cat([xe[1:], zero])
        Ae_next = torch.cat([Ae[1:], Ae.new_zeros((1, 6, 6))])
        t = ro - _bmv(Ao, xe) - _bmv_t(Ae_next, xe_next)
        xo = _bmv(Bo_inv, t)
        x = torch.stack([xe, xo], dim=1).reshape(-1, 6)
    return x[:K]


def chain_preconditioner(subdiag: Tensor, D: Tensor, node_count: Tensor,
                         K: int):
    """Build M⁻¹ for the PCG from the block-tridiagonal CHAIN part of H.

    ``subdiag``: its sub-diagonal blocks (:func:`_chain_subdiag`, summed
    over every factor shard); ``D``: the full block diagonal (prior +
    regularization included).  Nodes ≥ ``node_count`` get an identity block
    so the padded tail stays decoupled and exactly solvable."""
    aliveK = torch.arange(K, device=D.device) < node_count
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    B = torch.where(aliveK[:, None, None], D, eye)
    both = aliveK & torch.cat([aliveK.new_zeros((1,)), aliveK[:-1]])
    A = torch.where(both[:, None, None], subdiag, 0.0)
    levels, B1_inv = _cr_factor(A, B)
    alive = aliveK[:, None].to(D.dtype)

    def M_inv(rv):
        return _cr_solve(levels, B1_inv, rv) * alive

    return M_inv


def _pcg(matvec, b: Tensor, M_inv, iters: int, rtol: float = 1e-6):
    """Preconditioned conjugate gradient on (K,6) vectors.

    Convergence on RELATIVE residual (‖r‖ ≤ rtol·‖b‖) — the stiff odometry
    weights put absolute gradient scales at ~1e6.  One counted host read
    per test of the exit condition.  Returns (x, iterations run)."""
    x = torch.zeros_like(b)
    r = b
    z = M_inv(r)
    p = z
    rz = torch.sum(r * z)
    tol2 = rtol * rtol * torch.sum(b * b)
    it = 0
    while it < iters and host_bool(torch.sum(r * r) > tol2):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def gn_solve(poses: Tensor, node_count: Tensor, g: FactorGraph, shards,
             reduce, gn_iters: int, pcg_iters: int, return_iters: bool):
    """Batched GN over all poses, the factors split into ``shards``: (device,
    slice of ``g``, its i and j as int64) each.  Every partial sum — the
    gradient, D, the chain sub-diagonal, each H·x — is computed per shard on
    its device and summed by ``reduce`` (list of partials → their sum on the
    device of ``poses``); the prior, the preconditioner and the PCG are
    computed once there.  One shard and ``reduce = parts[0]`` is the
    single-device solve."""
    K = poses.shape[0]
    home = poses.device
    alive = (torch.arange(K, device=home) < node_count)[:, None]
    prior_w2 = g.prior_weight ** 2
    prior_w = torch.sqrt(prior_w2)
    eye = torch.eye(6, dtype=poses.dtype, device=home)
    # the incidence is fixed for the whole solve: one sum plan a shard
    plans = [(_incidence(gi, gj, K), _chain_incidence(local, K))
             for _, local, gi, gj in shards]
    iters = []
    for _ in range(gn_iters):
        blocks, grads, diags, subs = [], [], [], []
        for (dev, local, gi, gj), (nodes, chain) in zip(shards, plans):
            r, Ai, Aj = _factor_blocks(poses.to(dev), local, gi, gj)
            blocks.append((Ai, Aj))
            grads.append(_node_sum(_bmv_t(Ai, r), _bmv_t(Aj, r), nodes))
            diags.append(_block_diag(gi, gj, Ai, Aj, K, nodes))
            subs.append(_chain_subdiag(local, Ai, Aj, K, chain))
        grad = reduce(grads)
        grad[0] += prior_w * ((poses[0] - g.prior) * prior_w)
        D = reduce(diags)
        D[0] += torch.diag(prior_w2)
        M_inv = chain_preconditioner(reduce(subs), D + 1e-6 * eye,
                                     node_count, K)

        def matvec(x):
            y = reduce([_hvp(x.to(dev), gi, gj, Ai, Aj, nodes)
                        for (dev, _, gi, gj), (Ai, Aj), (nodes, _c)
                        in zip(shards, blocks, plans)])
            y[0] += prior_w2 * x[0]
            return (y + 1e-8 * x) * alive

        delta, it = _pcg(matvec, -grad * alive, M_inv, pcg_iters)
        upd = poses + delta * alive
        poses = torch.where(alive, se3.normalize_angles(upd), upd)
        iters.append(it)
    return (poses, iters) if return_iters else poses


def optimize_poses(poses: Tensor, node_count: Tensor, g: FactorGraph,
                   gn_iters: int = 8, pcg_iters: int = 64,
                   return_iters: bool = False):
    """Batched GN over all poses.  Nodes ≥ ``node_count`` are frozen (their
    factor slots are invalid anyway).  Returns corrected (K,6); with
    ``return_iters`` also the list of PCG iteration counts, one per GN step
    (host ints).  ``distributed/sharded_pgo.py`` runs the same solve with
    the factors sharded over a mesh."""
    shard = (poses.device, g, g.i.to(torch.int64), g.j.to(torch.int64))
    return gn_solve(poses, node_count, g, [shard], lambda parts: parts[0],
                    gn_iters, pcg_iters, return_iters)

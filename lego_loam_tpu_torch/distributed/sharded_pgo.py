"""Distributed pose-graph optimisation — factors sharded over a mesh.

The reference's iSAM2 graph is a single-threaded native library.  Here the
factor axis is cut into one slice per shard of a :class:`~.mesh.Mesh`, and
each Gauss-Newton / PCG iteration needs exactly ONE reduction per partial
sum: the gradient, the block diagonal D, the chain sub-diagonal and each
Hessian-vector product.  Poses stay replicated (6·K floats is tiny next to
the factor blocks).  The solve is ``graph/posegraph.py``'s own Gauss-Newton
loop (``_gn_solve``): this module gives it the shards and the reduction.

Counterpart of the JAX package's ``distributed/sharded_pgo.py``, where
``shard_map`` runs the body on every device and ``psum`` reduces.  In the
port a shard is a device with its slice of the factors, and the reduction
(:func:`_psum`) adds the shards' partials IN SHARD ORDER on the device of
the poses, then, on a mesh over a process group, all-reduces that sum
(``torch.distributed.all_reduce``).  The replicated part — the poses, the
preconditioner, the PCG vectors and scalars — is computed once there, not
once per shard; each shard receives the vectors it multiplies.  Every
process ends with the same bits (a collective's result is the same on every
rank), so all of them take the same number of PCG iterations: one counted
host read per iteration, as in the single-device solve.

Within a shard the sums run in the order ``core/segsum.py`` fixes, so a
sharded solve repeats bit for bit; its partial sums differ from the
single-device order by rounding only, and ``tests/test_torch_distributed.py``
states the tolerances.
"""

from __future__ import annotations

import threading

import torch

from ..graph.posegraph import FactorGraph, _gn_solve

Tensor = torch.Tensor

solve_count = 0          # +1 per call of optimize_poses_sharded
all_reduce_count = 0     # +1 per torch.distributed.all_reduce of _psum
_count_lock = threading.Lock()


def _pad_factors(g: FactorGraph, n_shards: int) -> FactorGraph:
    """Pad the factor axis with invalid factors to a multiple of the shard
    count (``i = j = 0``, zero weight: they add exact zeros)."""
    F = g.i.shape[0]
    pad = (-F) % n_shards
    if pad == 0:
        return g

    def grow(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return g.replace(i=grow(g.i), j=grow(g.j), z=grow(g.z),
                     weight=grow(g.weight), valid=grow(g.valid))


def _shards(g: FactorGraph, mesh):
    """This process's factor slices, each on its shard's device: shard s of
    the mesh takes factors ``[s·F/n, (s+1)·F/n)`` of the padded graph."""
    n = mesh.size
    g = _pad_factors(g, n)
    per = g.i.shape[0] // n
    out = []
    for k, dev in enumerate(mesh.devices):
        s = mesh.process_index * len(mesh.devices) + k
        part = slice(s * per, (s + 1) * per)
        local = FactorGraph(
            i=g.i[part].to(dev), j=g.j[part].to(dev), z=g.z[part].to(dev),
            weight=g.weight[part].to(dev), valid=g.valid[part].to(dev),
            prior=g.prior.to(dev), prior_weight=g.prior_weight.to(dev))
        out.append((dev, local, local.i.to(torch.int64),
                    local.j.to(torch.int64)))
    return out


def _psum(parts, mesh, home: torch.device) -> Tensor:
    """The sum over every shard of the mesh: this process's partials added
    in shard order on ``home``, then, on a mesh over a process group,
    all-reduced across its processes (also with one process: the backend's
    reduction then runs and adds nothing)."""
    global all_reduce_count
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    if mesh.process_group:
        import torch.distributed as dist
        dist.all_reduce(total)
        with _count_lock:
            all_reduce_count += 1
    return total


def optimize_poses_sharded(poses: Tensor, node_count: Tensor, g: FactorGraph,
                           mesh, gn_iters: int = 8, pcg_iters: int = 64,
                           return_iters: bool = False):
    """Same result as ``graph/posegraph.py::optimize_poses``, with the factor
    axis sharded over ``mesh`` and one reduction per partial sum.  The
    result lies on the device of ``poses``; with ``return_iters`` also the
    list of PCG iteration counts, one per GN step (host ints, the same on
    every process)."""
    global solve_count
    with _count_lock:
        solve_count += 1
    home = poses.device
    return _gn_solve(poses, node_count, g, _shards(g, mesh),
                     lambda parts: _psum(parts, mesh, home),
                     gn_iters, pcg_iters, return_iters)

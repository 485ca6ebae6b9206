"""Multi-process distributed runtime (``torch.distributed`` + global mesh).

The reference has no distributed communication backend at all — its only
transport is an in-process channel plus ROS topics.  Here N processes join
one ``torch.distributed`` process group; their local shards form one GLOBAL
mesh (ranks × local shards), and the sharded code paths run across them:
the factor-sharded pose-graph solve (``distributed/sharded_pgo.py``: each
partial summed over the process's shards, then ``all_reduce``\\ d), the
single-stream ``replay(mesh=…)`` whose keyframe rows are spread over every
process (``graph/keyframes.py::RowShards``: each gather all-reduced) and the
data-parallel replay (each process replays its own streams with
``distributed/mesh.py::replay_sharded``; the outputs are gathered).
Counterpart of the JAX package's ``distributed/multihost.py``
(``jax.distributed`` and one global device mesh).

The backend is the caller's choice, never switched: ``gloo`` all-reduces CPU
and CUDA tensors (and gathers CPU ones), so it runs on the CPU and also puts
two processes on ONE card; ``nccl`` takes CUDA tensors only and refuses two
ranks on one card, so it needs a card per process.  Outputs are gathered on
the backend's device and brought to the CPU.

Worker entry point (``tests/test_torch_multihost.py``, ``chip_smoke.py``)::

    python -m lego_loam_tpu_torch.distributed.multihost \\
        --coordinator localhost:12345 --num-processes 2 --process-id 0 \\
        --out mh.npz --backend gloo [--device cpu] [--local-devices 2]

Every process is started the same way with its own ``--process-id``;
process 0 writes the results.  ``--device`` names the device of this
process's shards; without it, process r takes card ``r mod (cards)`` and a
machine without a card raises.  ``--bench`` times the replay instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..core import se3
from ..core.config import (FeatureConfig, LaserConfig, LegoLoamConfig,
                           MappingConfig, PipelineConfig)
from ..core.device import DeviceLike, resolve_device
from ..graph.posegraph import add_factor, empty_graph
from ..io.npz_io import pack_sequence
from ..io.synthetic import make_sequence
from ..pipeline.slam import replay
from . import mesh as mesh_mod
from .mesh import Mesh, replay_sharded
from .sharded_pgo import optimize_poses_sharded

TIMEOUT_S = 60.0      # process-group set-up and every collective


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str) -> None:
    """Join the process group at ``tcp://coordinator`` (idempotent)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def global_mesh(devices: Sequence[DeviceLike]) -> Mesh:
    """One mesh over every process's shards: this process contributes
    ``devices``, every other process as many."""
    import torch.distributed as dist
    return Mesh(devices=tuple(torch.device(d) for d in devices),
                process_count=dist.get_world_size(),
                process_index=dist.get_rank(), process_group=True)


def _psum_check(mesh: Mesh) -> float:
    """A reduction that provably crossed process boundaries: the sum of
    every shard's global index must equal N(N-1)/2."""
    first = mesh.process_index * len(mesh.devices)
    parts = [torch.tensor(float(first + k), device=dev)
             for k, dev in enumerate(mesh.devices)]
    out = float(mesh.psum(parts, mesh.devices[0]))
    n = mesh.size
    expected = n * (n - 1) / 2.0
    if out != expected:
        raise AssertionError(f"psum {out} != {expected}")
    return out


def _pgo_graph(device: DeviceLike = None):
    """Deterministic loop graph (drifted circle + one loop factor) — the
    same on every process, so the sharded solve must agree with the
    single-device solve computed anywhere.  A copy of the JAX package's
    ``distributed/multihost.py::_pgo_graph``."""
    device = resolve_device(device)
    K = 64
    n = 24
    g = empty_graph(128, device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    w = torch.tensor([200.0] * 3 + [30.0] * 3, dtype=torch.float32,
                     device=device)
    p = torch.zeros((K, 6), dtype=torch.float32, device=device)
    z = torch.tensor([0.0, 0.0, 2 * np.pi / n * 1.02, 0.8, 0.0, 0.0],
                     dtype=torch.float32, device=device)
    for k in range(1, n):
        p[k] = se3.compose(p[k - 1], z)
        g, count = add_factor(g, count, torch.tensor(k - 1), torch.tensor(k),
                              z, w)
    z_loop = torch.zeros((6,), dtype=torch.float32, device=device)
    g, count = add_factor(g, count, torch.tensor(n - 1), torch.tensor(0),
                          z_loop, w * 0.2)
    return p, torch.tensor(n, dtype=torch.int32, device=device), g


def replay_config() -> LegoLoamConfig:
    """The shrunken geometry of the workers' replay (that of the JAX
    package's multi-process test): 360 columns, loop closure off."""
    return LegoLoamConfig(
        laser=LaserConfig(num_horizontal_scans=360),
        feature=FeatureConfig(max_sharp=64, max_less_sharp=512,
                              max_flat=128, max_less_flat=2048,
                              odom_surf_iters=5, odom_corner_iters=5),
        mapping=MappingConfig(max_map_corner=4096, max_map_surf=8192,
                              max_keyframes=64, scan2map_iters=2,
                              surrounding_keyframe_search_num=4,
                              enable_loop_closure=False),
        pipeline=PipelineConfig(max_points=8192, max_segmented=4096),
    )


def store_config(rows: int) -> LegoLoamConfig:
    """:func:`replay_config` with a mapping cycle every scan, a keyframe
    every cycle and ``rows`` keyframe rows: the meshed replay's, where
    ``rows`` scans with a mesh of ``rows`` shards write one row a shard."""
    cfg = replay_config()
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, mapping_frequency_divider=1, keyframe_distance=0.0,
        max_keyframes=rows))


def stream_sequence(stream: int, n_scans: int):
    """(scans, gt, times) of global stream ``stream`` of the workers."""
    return make_sequence(n_scans, replay_config(), seed=100 + stream,
                         noise=0.01, radius=6.0)


def _local_streams(mesh: Mesh, n_scans: int, device: torch.device):
    """This process's streams, one per local shard, packed (B, N, …)."""
    cfg = replay_config()
    first = mesh.process_index * len(mesh.devices)
    packed = []
    for b in range(len(mesh.devices)):
        scans, _, times = stream_sequence(first + b, n_scans)
        packed.append(pack_sequence(scans, times, cfg, device=device))
    return tuple(torch.stack([p[k] for p in packed]) for k in range(3))


def _gather(local: torch.Tensor, backend: str) -> np.ndarray:
    """Every process's ``local`` (same shape), stacked in rank order, on
    the CPU.  ``gloo`` gathers CPU tensors, ``nccl`` CUDA tensors."""
    import torch.distributed as dist
    if backend == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts).cpu().numpy()


def _setup(coordinator: str, num_processes: int, process_id: int,
           device: DeviceLike, backend: str, local_devices: int):
    """Resolve this process's device, join the group, build the mesh."""
    if device is None:
        resolve_device(None)                      # raises without a card
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(coordinator, num_processes, process_id, backend)
    return device, global_mesh([device] * local_devices)


def run_worker(coordinator: str, num_processes: int, process_id: int,
               out_path: str, backend: str, n_scans: int = 5,
               local_devices: int = 2, device: DeviceLike = None) -> None:
    """Worker body: join the group, run the cross-process psum check, the
    factor-sharded pose-graph solve over the global mesh, a ``replay`` of
    stream 0 over the global mesh (:func:`store_config`: a keyframe row on
    every shard, so its gathers cross processes; every process replays the
    same scans and ends with the same state), and a data-parallel replay of
    this process's own streams (one a local shard); process 0 writes the
    results.  A barrier runs before the group is torn down."""
    import torch.distributed as dist
    device, mesh = _setup(coordinator, num_processes, process_id, device,
                          backend, local_devices)
    try:
        psum_val = _psum_check(mesh)

        poses, n_nodes, g = _pgo_graph(device)
        solved, pcg_iters = optimize_poses_sharded(
            poses, n_nodes, g, mesh, gn_iters=6, pcg_iters=64,
            return_iters=True)
        all_reduces = mesh_mod.all_reduce_count

        rows = mesh.size
        store_cfg = store_config(rows)
        scans, _, times = stream_sequence(0, rows)
        state, mesh_outs = replay(
            *pack_sequence(scans, times, store_cfg, device=device),
            store_cfg, device=device, mesh=mesh)
        mesh_reduces = mesh_mod.all_reduce_count - all_reduces
        # rows written in each shard, gathered in global shard order
        parts = state.mapping.clouds.surf_valid.parts
        written = _gather(torch.stack([p.any(dim=1).sum() for p in parts]),
                          backend)
        blocks = convert.to_numpy_tree(state.mapping.clouds)  # a collective

        x, v, t = _local_streams(mesh, n_scans, device)
        local_mesh = Mesh(devices=mesh.devices)
        _, outs = replay_sharded(x, v, t, replay_config(), local_mesh)
        fused = _gather(outs["fused"], backend)
        if process_id == 0:
            np.savez(out_path, psum=psum_val, solved=solved.cpu().numpy(),
                     pcg_iterations=np.asarray(pcg_iters), fused=fused,
                     all_reduces=all_reduces, n_devices=mesh.size,
                     n_processes=num_processes,
                     mesh_fused=mesh_outs["fused"].cpu().numpy(),
                     mesh_rows_per_shard=written,
                     mesh_all_reduces=mesh_reduces,
                     **{f"mesh_{k}": blk for k, blk in blocks.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def bench_worker(coordinator: str, num_processes: int, process_id: int,
                 out_path: str, backend: str, n_scans: int = 40,
                 local_devices: int = 2, device: DeviceLike = None) -> None:
    """Timed data-parallel replay across processes: every process replays
    its own streams between two barriers (after a warm-up on two scans);
    process 0 writes the aggregate scans/s of all of them."""
    import torch.distributed as dist
    device, mesh = _setup(coordinator, num_processes, process_id, device,
                          backend, local_devices)
    try:
        cfg = replay_config()
        x, v, t = _local_streams(mesh, n_scans, device)
        local_mesh = Mesh(devices=mesh.devices)
        replay_sharded(x[:, :2], v[:, :2], t[:, :2], cfg, local_mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        t0 = time.perf_counter()
        replay_sharded(x, v, t, cfg, local_mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        dt = time.perf_counter() - t0
        if process_id == 0:
            np.savez(out_path, rate=mesh.size * n_scans / dt, seconds=dt,
                     n_devices=mesh.size, n_processes=num_processes)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-scans", type=int, default=5)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="shards of this process (on its one device)")
    ap.add_argument("--bench", action="store_true",
                    help="time the data-parallel replay instead")
    ap.add_argument("--device", default=None,
                    help="this process's device (default: card r mod cards)")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    worker = bench_worker if args.bench else run_worker
    worker(args.coordinator, args.num_processes, args.process_id, args.out,
           args.backend, n_scans=args.n_scans,
           local_devices=args.local_devices, device=args.device)
    print(f"[multihost] process {args.process_id} done", file=sys.stderr)


if __name__ == "__main__":
    main()

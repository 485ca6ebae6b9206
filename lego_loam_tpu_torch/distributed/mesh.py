"""Mesh construction + data-parallel replay sharding.

The reference has no distributed story — its scale axis is threads in one
process.  Here a mesh is an ordered tuple of shards: independent replay
streams (multi-session) shard over it (:func:`replay_sharded`); in the
single-stream mode (``pipeline/slam.py::replay(mesh=…)``) the keyframe cloud
blocks row-shard over it (``graph/keyframes.py::RowShards``) and the
pose-graph factor axis too (``distributed/sharded_pgo.py``).  The JAX
package names the mesh's axis to pick a ``shard_map`` axis; a port mesh has
one axis and no name.

A shard is a device.  A device may appear more than once: several shards on
one card (or on the CPU) share it, which is how a one-card machine and the
CPU tests run meshes of several shards.  A mesh may also span processes
(``distributed/multihost.py::global_mesh``): its ``devices`` are then this
process's shards, and its size counts the shards of every process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import torch

from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device
from ..pipeline.slam import batched_replay

Tensor = torch.Tensor

all_reduce_count = 0     # +1 per torch.distributed.all_reduce of Mesh.psum
_count_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of shards.  ``devices``: this process's shards, in
    order.  With ``process_group`` the mesh spans the default
    ``torch.distributed`` process group: its ``process_count`` processes
    hold as many shards each, process ``process_index`` holds global shards
    ``[process_index · len(devices), …)``, and sums over the mesh are
    all-reduced over the group."""
    devices: Tuple[torch.device, ...]
    process_count: int = 1
    process_index: int = 0
    process_group: bool = False

    @property
    def size(self) -> int:
        """Shards over every process."""
        return len(self.devices) * self.process_count

    def psum(self, parts, home: torch.device) -> Tensor:
        """The sum over every shard of the mesh: this process's partials
        (one a local shard) added in shard order on ``home``, then, on a
        mesh over a process group, all-reduced across its processes (also
        with one process: the backend's reduction then runs and adds
        nothing)."""
        global all_reduce_count
        total = parts[0].to(home)
        for p in parts[1:]:
            total = total + p.to(home)
        if self.process_group:
            import torch.distributed as dist
            dist.all_reduce(total)
            with _count_lock:
                all_reduce_count += 1
        return total


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A one-process mesh.  ``devices`` (may repeat a device) — by default
    every CUDA card, and a machine without one raises; ``n_devices`` takes
    the first n of them (default: all)."""
    if devices is None:
        resolve_device(None)                 # raises without a card
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if not 1 <= n <= len(devices):
        raise ValueError(f"{n} shards asked of {len(devices)} devices")
    return Mesh(devices=tuple(devices[:n]))


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device of this thread (nothing on the
    CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def replay_sharded(xyz: Tensor, valid: Tensor, times: Tensor,
                   cfg: LegoLoamConfig, mesh: Mesh):
    """Replay B independent sequences, sharded over ``mesh``'s devices.

    Args: (B, N, P*3) / (B, N, P) / (B, N) stacked sequences (coordinates
    row-flattened, see ``io.npz_io.pack_sequence``); B must be divisible by
    the number of this process's shards (a mesh over several processes
    shards each process's own streams).  Shard k replays streams ``[k·B/n,
    (k+1)·B/n)`` with ``pipeline/slam.py::batched_replay`` on its device, in
    a host thread of its own (the idiom of ``torch.nn.parallel.
    parallel_apply``: each thread enters its device and launches on that
    device's current stream); an exception in any thread is raised here.

    Returns (final_states: a list of B ``SlamState``s, each on its shard's
    device; outputs dict of (B, N, …) tensors on the device of ``xyz``),
    each stream's equal to its own ``replay``.
    """
    n = len(mesh.devices)
    B = xyz.shape[0]
    if B % n:
        raise ValueError(f"{B} streams do not divide over {n} shards")
    per = B // n
    results: list = [None] * n
    errors: list = [None] * n

    def work(k: int) -> None:
        dev = mesh.devices[k]
        part = slice(k * per, (k + 1) * per)
        try:
            with _on(dev):
                results[k] = batched_replay(
                    xyz[part].to(dev), valid[part].to(dev),
                    times[part].to(dev), cfg, device=dev)
        except BaseException as e:   # noqa: BLE001 — re-raised by the caller
            errors[k] = e

    if n == 1:
        work(0)
    else:
        # PyTorch loads its CUDA linear-algebra library at the first
        # torch.linalg call on a card, and two threads making that first
        # call together fail ("lazy wrapper should be called at most once"):
        # load it here, in one thread, before the shards start
        for dev in {d for d in mesh.devices if d.type == "cuda"}:
            with _on(dev):
                torch.linalg.solve_ex(torch.eye(1, device=dev),
                                      torch.ones((1, 1), device=dev))
        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    states = [s for shard_states, _ in results for s in shard_states]
    outputs = {}
    if results[0][1]:
        outputs = {key: torch.cat([o[key].to(xyz.device)
                                   for _, o in results])
                   for key in results[0][1]}
    return states, outputs

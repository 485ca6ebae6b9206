"""Keyframe store — fixed-capacity arrays.

Replaces the reference's dynamically grown keyframe structures
(``cloudKeyPoses3D/6D``, ``cornerCloudKeyFrames`` etc.,
``mapOptmization.cpp:1431-1474``) with preallocated (K, …) tensors + a
count.

In-place updates: unlike the JAX package, whose arrays are immutable,
:func:`apply_row` WRITES the inserted row into the keyframe blocks it is
given and returns the same tensors.  The blocks are by far the largest
state of the pipeline (K × (1024 + 2048 + 512 + 512) points of float32 plus
masks), and copying them per scan would cost more than the rest of the step.
A caller that needs the old blocks must clone them first.  The small
metadata (poses, stamps, counters) is never written in place.

Placement: a block is a whole (K, …) tensor on the state's device or, in
the single-stream sharded mode (``pipeline/slam.py::replay(mesh=…)``), a
:class:`RowShards` — its rows cut over the shards of a mesh, as the JAX
package row-shards them (``NamedSharding(mesh, P(axis))``).  Every reader
goes through :func:`take_rows` and every write through :func:`put_row_`,
which take both alike; :func:`whole` assembles a block back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import se3
from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device
from ..core.types import Container
from ..distributed.sharded_pgo import _psum
from ..match.voxelhash import voxel_downsample, voxel_hash_downsample
from ..solve.scan2map import MapCloud

Tensor = torch.Tensor

# per-keyframe cloud capacities (post voxel-downsample)
CORNER_CAP = 1024
SURF_CAP = 2048
OUTLIER_CAP = 512
SCAN2D_CAP = 512


class RowShards:
    """One (K, …) keyframe block row-sharded over a mesh of n =
    ``mesh.size`` shards: global shard s holds the contiguous rows
    ``[s·r, min((s+1)·r, K))``, r = ceil(K / n) — the row layout of the JAX
    package's ``NamedSharding(mesh, P(axis))``.  ``parts`` are THIS
    process's shards, each on its shard's device (a device may repeat); on a
    mesh over a process group the other processes hold the other rows, and
    global shard s = ``process_index · len(devices) + k`` for local shard k.
    ``home`` is the state's device, where :func:`take_rows` lands its rows.
    ``shape`` is the whole block's."""

    def __init__(self, parts, mesh, rows: int, home: torch.device):
        self.parts = tuple(parts)
        self.mesh = mesh
        self.home = home
        self.shape = (rows,) + tuple(self.parts[0].shape[1:])
        self.dtype = self.parts[0].dtype
        self.per_shard, self.spans = _layout(rows, mesh)

    def take(self, idx: Tensor) -> Tensor:
        owner = idx // self.per_shard
        first = self.mesh.process_index * len(self.mesh.devices)
        out = torch.zeros((idx.shape[0],) + self.shape[1:], dtype=self.dtype,
                          device=self.home)
        for k, ((a, b), part) in enumerate(zip(self.spans, self.parts)):
            if a == b:
                continue                 # a trailing shard with no rows
            local = torch.clamp(idx - a, 0, b - a - 1).to(part.device)
            rows = part.index_select(0, local).to(self.home)
            mine = (owner == first + k).reshape(
                (-1,) + (1,) * (rows.dim() - 1))
            out = torch.where(mine, rows, out)
        if self.mesh.process_group:
            out = _psum_bits(out, self.mesh, self.home)
        return out

    def put_(self, idx: Tensor, val: Tensor) -> "RowShards":
        for (a, b), part in zip(self.spans, self.parts):
            if a == b:
                continue
            local = torch.where((idx >= a) & (idx < b), idx - a, b - a)
            put_row_(part, local.to(part.device), val.to(part.device))
        return self


def _layout(rows: int, mesh):
    """(r, this process's (first, end) row spans) of :class:`RowShards`."""
    n = mesh.size
    if n > rows:
        raise ValueError(f"a mesh of {n} shards over {rows} keyframe rows")
    r = -(-rows // n)
    first = mesh.process_index * len(mesh.devices)
    return r, tuple((min(s * r, rows), min((s + 1) * r, rows))
                    for s in range(first, first + len(mesh.devices)))


def _psum_bits(t: Tensor, mesh, home: torch.device) -> Tensor:
    """Sum over the mesh of a tensor that is zero on every process but the
    owner's, exactly: float32 bits summed as int32 (one term plus zeros), a
    bool mask as uint8."""
    if t.dtype == torch.bool:
        return _psum([t.to(torch.uint8)], mesh, home).to(torch.bool)
    return _psum([t.view(torch.int32)], mesh, home).view(t.dtype)


def shard_rows(block: Tensor, mesh) -> RowShards:
    """A whole (K, …) block cut into :class:`RowShards` over ``mesh`` (this
    process's rows copied to its shards' devices)."""
    _, spans = _layout(block.shape[0], mesh)
    parts = [block[a:b].to(dev, copy=True)
             for (a, b), dev in zip(spans, mesh.devices)]
    return RowShards(parts, mesh, block.shape[0], block.device)


def whole(block) -> Tensor:
    """The whole (K, …) block on the state's device.  On a mesh over a
    process group this is a collective: every process must call it."""
    if isinstance(block, Tensor):
        return block
    if not block.mesh.process_group:
        return torch.cat([p.to(block.home) for p in block.parts])
    return block.take(torch.arange(block.shape[0], device=block.home))


def take_rows(block, idx: Tensor) -> Tensor:
    """``block[idx]`` for a 1-D index tensor, on the state's device, for a
    whole block and a :class:`RowShards` alike — bit for bit, in ``idx``
    order, with no host read: each shard gathers its clamped local rows,
    and the owner's are selected on the device (on a mesh over a process
    group, summed exactly across processes)."""
    idx = idx.to(torch.int64)
    if isinstance(block, Tensor):
        return block.index_select(0, idx)
    return block.take(idx)


@dataclasses.dataclass
class KeyframeClouds(Container):
    """The BIG per-keyframe cloud blocks, kept separate from the pose/stamp
    metadata so they can be updated in place (see the module docstring).

    Cloud blocks are stored ROW-FLATTENED (K, C*3), the JAX package's
    layout; use :func:`as_points` to view a gathered row as (…, C, 3).
    Each block is a tensor or, under a mesh, a :class:`RowShards`."""

    corner: Tensor        # (K, CORNER_CAP*3)  sensor frame
    corner_valid: Tensor  # (K, CORNER_CAP)
    surf: Tensor          # (K, SURF_CAP*3)    (surf + outlier separate)
    surf_valid: Tensor    # (K, SURF_CAP)
    outlier: Tensor       # (K, OUTLIER_CAP*3)
    outlier_valid: Tensor
    scan2d: Tensor        # (K, SCAN2D_CAP*3)  sensor frame (z≈chest)
    scan2d_valid: Tensor

    @property
    def capacity(self) -> int:
        return self.corner.shape[0]


@dataclasses.dataclass
class KeyframeRow(Container):
    """One keyframe's cloud payload + destination row.  ``idx == capacity``
    means "write nothing"."""

    idx: Tensor           # () int32, == capacity ⇒ dropped
    corner: Tensor        # (CORNER_CAP*3,)
    corner_valid: Tensor
    surf: Tensor
    surf_valid: Tensor
    outlier: Tensor
    outlier_valid: Tensor
    scan2d: Tensor
    scan2d_valid: Tensor


@dataclasses.dataclass
class KeyframeStore(Container):
    """Pose/stamp metadata + a :class:`KeyframeClouds` — the read view the
    submap code consumes."""

    pose: Tensor          # (K, 6) map-frame keyframe poses
    stamp: Tensor         # (K,)
    count: Tensor         # ()  int32
    clouds: KeyframeClouds

    # field passthroughs so call sites read store.corner etc. directly
    @property
    def corner(self) -> Tensor:
        return self.clouds.corner

    @property
    def corner_valid(self) -> Tensor:
        return self.clouds.corner_valid

    @property
    def surf(self) -> Tensor:
        return self.clouds.surf

    @property
    def surf_valid(self) -> Tensor:
        return self.clouds.surf_valid

    @property
    def outlier(self) -> Tensor:
        return self.clouds.outlier

    @property
    def outlier_valid(self) -> Tensor:
        return self.clouds.outlier_valid

    @property
    def scan2d(self) -> Tensor:
        return self.clouds.scan2d

    @property
    def scan2d_valid(self) -> Tensor:
        return self.clouds.scan2d_valid

    @property
    def capacity(self) -> int:
        return self.pose.shape[0]


_BLOCKS = ("corner", "corner_valid", "surf", "surf_valid",
           "outlier", "outlier_valid", "scan2d", "scan2d_valid")


def as_points(flat: Tensor) -> Tensor:
    """(…, C*3) → (…, C, 3)."""
    return flat.reshape(flat.shape[:-1] + (-1, 3))


def as_flat(pts: Tensor) -> Tensor:
    """(…, C, 3) → (…, C*3)."""
    return pts.reshape(pts.shape[:-2] + (-1,))


def empty_clouds(cfg: LegoLoamConfig, device: DeviceLike = None,
                 mesh=None) -> KeyframeClouds:
    """Zero blocks on ``device`` or, with ``mesh``, row-sharded over it
    (``device`` is then the home of their gathers)."""
    device = resolve_device(device)
    K = cfg.mapping.max_keyframes

    def z(shape, dtype):
        if mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        _, spans = _layout(K, mesh)
        return RowShards([torch.zeros((b - a,) + shape[1:], dtype=dtype,
                                      device=dev)
                          for (a, b), dev in zip(spans, mesh.devices)],
                         mesh, K, device)

    return KeyframeClouds(
        corner=z((K, CORNER_CAP * 3), torch.float32),
        corner_valid=z((K, CORNER_CAP), torch.bool),
        surf=z((K, SURF_CAP * 3), torch.float32),
        surf_valid=z((K, SURF_CAP), torch.bool),
        outlier=z((K, OUTLIER_CAP * 3), torch.float32),
        outlier_valid=z((K, OUTLIER_CAP), torch.bool),
        scan2d=z((K, SCAN2D_CAP * 3), torch.float32),
        scan2d_valid=z((K, SCAN2D_CAP), torch.bool))


def empty_store(cfg: LegoLoamConfig, device: DeviceLike = None
                ) -> KeyframeStore:
    device = resolve_device(device)
    K = cfg.mapping.max_keyframes
    return KeyframeStore(
        pose=torch.zeros((K, 6), dtype=torch.float32, device=device),
        stamp=torch.zeros((K,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        clouds=empty_clouds(cfg, device))


def make_row(idx: Tensor,
             corner: Tensor, corner_valid: Tensor,
             surf: Tensor, surf_valid: Tensor,
             outlier: Tensor, outlier_valid: Tensor,
             scan2d: Tensor, scan2d_valid: Tensor) -> KeyframeRow:
    """Pack one keyframe's clouds (each (C, 3)) into a row payload."""
    return KeyframeRow(
        idx=idx,
        corner=as_flat(corner), corner_valid=corner_valid,
        surf=as_flat(surf), surf_valid=surf_valid,
        outlier=as_flat(outlier), outlier_valid=outlier_valid,
        scan2d=as_flat(scan2d), scan2d_valid=scan2d_valid)


def null_row(capacity: int, device: DeviceLike = None) -> KeyframeRow:
    """A row whose write is dropped (idx == capacity)."""
    device = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KeyframeRow(
        idx=torch.tensor(capacity, dtype=torch.int32, device=device),
        corner=z((CORNER_CAP * 3,), torch.float32),
        corner_valid=z((CORNER_CAP,), torch.bool),
        surf=z((SURF_CAP * 3,), torch.float32),
        surf_valid=z((SURF_CAP,), torch.bool),
        outlier=z((OUTLIER_CAP * 3,), torch.float32),
        outlier_valid=z((OUTLIER_CAP,), torch.bool),
        scan2d=z((SCAN2D_CAP * 3,), torch.float32),
        scan2d_valid=z((SCAN2D_CAP,), torch.bool))


def place_clouds(clouds: KeyframeClouds, mesh) -> KeyframeClouds:
    """The blocks row-sharded over ``mesh``: as they are if they already
    are, else a sharded copy (a whole store, or one sharded over another
    mesh, is left untouched)."""
    return KeyframeClouds(**{
        name: (blk if isinstance(blk, RowShards) and blk.mesh == mesh
               else shard_rows(whole(blk), mesh))
        for name, blk in ((n, getattr(clouds, n)) for n in _BLOCKS)})


def take_row(arr, idx: Tensor) -> Tensor:
    """``arr[idx]`` for a () index tensor, without reading it on the host."""
    return take_rows(arr, idx.reshape(1))[0]


def put_row_(arr, idx: Tensor, val: Tensor):
    """IN PLACE ``arr[idx] = val``; an index past the end writes nothing
    (the row is rewritten with its own content), with no host read.  A
    :class:`RowShards` writes the row into its owner shard only."""
    if isinstance(arr, RowShards):
        return arr.put_(idx.to(torch.int64), val)
    cap = arr.shape[0]
    i = torch.clamp(idx.reshape(1).to(torch.int64), max=cap - 1)
    keep = arr.index_select(0, i)
    new = torch.where(idx < cap, val[None].to(arr.dtype), keep)
    return arr.index_copy_(0, i, new)


def put_row(arr: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """Out-of-place :func:`put_row_` for the small metadata arrays."""
    return put_row_(arr.clone(), idx, val)


def apply_row(clouds: KeyframeClouds, row: KeyframeRow) -> KeyframeClouds:
    """Write one row into the keyframe blocks IN PLACE (an index equal to
    the capacity drops it) and return the same container.  Sharded blocks
    take the row in its owner shard; every other shard is given its own
    row count as the index, which writes nothing."""
    for name in _BLOCKS:
        put_row_(getattr(clouds, name), row.idx, getattr(row, name))
    return clouds


def insert_keyframe(store: KeyframeStore, pose: Tensor, stamp: Tensor,
                    corner: Tensor, corner_valid: Tensor,
                    surf: Tensor, surf_valid: Tensor,
                    outlier: Tensor, outlier_valid: Tensor,
                    scan2d: Tensor, scan2d_valid: Tensor) -> KeyframeStore:
    """Append at position ``count`` (no-op when full) — offline/test
    convenience; the pipeline uses :func:`make_row`/:func:`apply_row`.
    The cloud blocks of ``store`` are updated in place."""
    K = store.capacity
    ok = store.count < K
    idx = torch.where(ok, store.count, K).to(torch.int32)
    row = make_row(idx, corner, corner_valid, surf, surf_valid,
                   outlier, outlier_valid, scan2d, scan2d_valid)
    return store.replace(
        pose=put_row(store.pose, idx, pose),
        stamp=put_row(store.stamp, idx, stamp),
        count=store.count + ok.to(store.count.dtype),
        clouds=apply_row(store.clouds, row))


def _transform_block(pose: Tensor, pts: Tensor, valid: Tensor):
    """Transform keyframe cloud blocks to world, masking invalid.
    pose (W,6), pts (W,C,3), valid (W,C)."""
    w = se3.apply(pose[:, None, :], pts)
    return torch.where(valid[..., None], w, 0.0)


def assemble_global_map(store: KeyframeStore, center: Tensor,
                        cfg: LegoLoamConfig, max_frames: int = 512,
                        capacity: int = 131072):
    """World-frame global feature map for visualization/export — the
    ``publishGlobalMap`` path (``mapOptmization.cpp:633-693``): keyposes
    within ``global_map_visualization_search_radius`` (500 m) of
    ``center``, their corner+surf+outlier clouds transformed to world and
    voxel-downsampled at 0.4 m (:688) by the spatial-hash filter.

    Returns (xyz (capacity, 3), valid (capacity,)).
    """
    m = cfg.mapping
    K = store.capacity
    dev = store.pose.device
    alive = torch.arange(K, device=dev) < store.count
    dp = store.pose[:, 3:] - center[3:]
    d = torch.sqrt(torch.sum(dp * dp, dim=-1))
    d = torch.where(alive & (d <= m.global_map_visualization_search_radius),
                    d, math.inf)
    # the max_frames nearest; a stable sort keeps equal distances in index
    # order, as the JAX package's top_k does
    d_sel, sel = torch.sort(d, stable=True)
    d_sel, sel = d_sel[:max_frames], sel[:max_frames]
    sel_ok = torch.isfinite(d_sel)

    pose = store.pose[sel]
    blocks, valids = [], []
    for blk, vld in ((store.corner, store.corner_valid),
                     (store.surf, store.surf_valid),
                     (store.outlier, store.outlier_valid)):
        ok = take_rows(vld, sel) & sel_ok[:, None]
        blocks.append(_transform_block(
            pose, as_points(take_rows(blk, sel)), ok).reshape(-1, 3))
        valids.append(ok.reshape(-1))
    xyz = torch.cat(blocks, dim=0)
    ok = torch.cat(valids, dim=0)
    out_xyz, _, out_ok = voxel_hash_downsample(
        xyz, xyz.new_zeros((xyz.shape[0], 0)), ok, m.surf_leaf_size,
        capacity)
    return out_xyz, out_ok


def assemble_submap(store: KeyframeStore, cur_pose: Tensor,
                    cfg: LegoLoamConfig, window: int = 50,
                    with_sat: bool = False):
    """Build the local corner/surf maps around the current pose.

    Merges the reference's two modes (``extractSurroundingKeyFrames``,
    ``mapOptmization.cpp:857-996``): the ``window`` nearest keyframes by
    keypose distance, gated by ``surrounding_keyframe_search_radius`` —
    equivalent to the latest-50 deque when driving forward and to the
    50 m radius search when revisiting.  Clouds are transformed to world,
    concatenated, and voxel-downsampled to fixed capacities (corner 0.2 m,
    surf(+outlier) 0.4 m, :988-995).

    Returns (corner_map: MapCloud, surf_map: MapCloud) — plus, with
    ``with_sat``, a () int32 count of voxels TRUNCATED by the
    ``max_map_corner``/``max_map_surf`` capacity cut.  These are
    WORLD-frame filters, where key-order truncation censors the map at
    an x-plane (see ``match/voxelhash.py``); the pipeline threads this
    into ``MappingMeta.map_sat`` so saturation is a counter, not a silent
    accuracy bug.
    """
    m = cfg.mapping
    K = store.capacity
    dev = store.pose.device
    alive = torch.arange(K, device=dev) < store.count
    dp = store.pose[:, 3:] - cur_pose[3:]
    d = torch.sqrt(torch.sum(dp * dp, dim=-1))
    d = torch.where(alive, d, math.inf)
    in_radius = d <= m.surrounding_keyframe_search_radius
    # nearest ``window`` keyframes; a stable sort resolves equal distances
    # to the lower keyframe index
    d_sel, sel_idx = torch.sort(torch.where(in_radius, d, math.inf),
                                stable=True)
    d_sel, sel_idx = d_sel[:window], sel_idx[:window]
    sel_ok = torch.isfinite(d_sel)                       # (window,)

    sel_pose = store.pose[sel_idx]

    def world(blk, vld):
        ok = take_rows(vld, sel_idx) & sel_ok[:, None]
        return _transform_block(sel_pose, as_points(take_rows(blk, sel_idx)),
                                ok), ok
    corner_w, corner_valid = world(store.corner, store.corner_valid)
    surf_w, surf_valid = world(store.surf, store.surf_valid)
    out_w, out_valid = world(store.outlier, store.outlier_valid)

    corner_xyz, corner_ok, n_vox_c = voxel_downsample(
        corner_w.reshape(-1, 3), corner_valid.reshape(-1),
        m.corner_leaf_size, m.max_map_corner, with_count=True)
    surf_all = torch.cat(
        [surf_w.reshape(-1, 3), out_w.reshape(-1, 3)], dim=0)
    surf_all_valid = torch.cat(
        [surf_valid.reshape(-1), out_valid.reshape(-1)], dim=0)
    surf_xyz, surf_ok, n_vox_s = voxel_downsample(
        surf_all, surf_all_valid, m.surf_leaf_size, m.max_map_surf,
        with_count=True)

    maps = (MapCloud(xyz=corner_xyz, valid=corner_ok),
            MapCloud(xyz=surf_xyz, valid=surf_ok))
    if with_sat:
        sat = (torch.clamp(n_vox_c - m.max_map_corner, min=0)
               + torch.clamp(n_vox_s - m.max_map_surf, min=0))
        return maps + (sat,)
    return maps

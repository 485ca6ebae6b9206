"""Voxel-grid downsampling as sort + segmented reduction.

Replacement for every ``pcl::VoxelGrid`` use in the reference
(``featureAssociation.cpp:101``, ``mapOptmization.cpp:71-84``): centroid of
the points falling in each leaf.  Dynamic output sizes become a fixed
``capacity`` with a validity mask.

Collision-free: voxel coordinates are packed into one 64-bit key and sorted
with a STABLE sort.  The key order is pinned to the JAX package's
two-int32-key lexsort — including the int32 wrap of its packed (y, z) key —
because callers rely on truncation in key order and the trajectory is
sensitive to the order candidates come out in.

The core works on a leading batch axis (B, N, …) — the per-ring filter of
``frontend/features.py`` is one batched call; the public functions take the
unbatched shapes of the JAX package and a batched variant beside them.
"""

from __future__ import annotations

import torch

from ..core.segsum import segment_sum, segments

Tensor = torch.Tensor

_OFFSET = 1 << 15          # voxel coords shifted to non-negative
_BITS = 1 << 16
_INVALID_K1 = 1 << 17      # sorts after every valid x key (≤ 65535)


def recip32(x: float) -> float:
    """``1 / x`` rounded to float32.  Compiled JAX code divides by a
    constant as a multiplication by its float32 reciprocal, which rounds
    differently from a division in about one quotient in seven; code that
    must put points in the same cells as the JAX package's jitted functions
    multiplies by this instead of dividing."""
    return float(torch.tensor(1.0) / torch.tensor(x, dtype=torch.float32))


def _voxel_coords(xyz: Tensor, leaf: float) -> Tensor:
    """Integer voxel coordinates as float32 in [0, 65535], computed as the
    JAX package's jitted filters compute them (``recip32``)."""
    q = torch.floor(xyz * recip32(leaf)) + float(_OFFSET)
    return torch.clamp(q, 0.0, float(_BITS - 1))


def _sort_key(q: Tensor, valid: Tensor) -> Tensor:
    """One int64 key whose order equals lexsort((k2, k1)) of the JAX
    package, where k1 = x and k2 = int32(y·2¹⁶ + z) WITH its wraparound
    (y ≥ 0 makes the product exceed 2³¹ and wrap negative)."""
    qi = q.to(torch.int64)
    k1 = qi[..., 0]
    k2 = qi[..., 1] * _BITS + qi[..., 2]
    k2 = torch.remainder(k2 + (1 << 31), 1 << 32)    # wrapped, shifted ≥ 0
    key = k1 * (1 << 32) + k2
    invalid_key = _INVALID_K1 * (1 << 32) + ((1 << 32) - 1)
    return torch.where(valid, key, invalid_key)


def _downsample_core(xyz: Tensor, payload: Tensor, valid: Tensor,
                     leaf: float, capacity: int):
    """Batched centroid filter.  xyz (B,N,3), payload (B,N,D), valid (B,N).

    Returns (mean (B,capacity,3+D), out_valid (B,capacity), n_vox (B,))."""
    B, N, _ = xyz.shape
    D = payload.shape[-1]
    dev = xyz.device

    q = _voxel_coords(xyz, leaf)
    order = torch.sort(_sort_key(q, valid), dim=1, stable=True).indices
    cat = torch.cat([q, xyz, payload], dim=-1)                 # (B,N,6+D)
    s = torch.gather(cat, 1, order[..., None].expand(B, N, 6 + D))
    vs = torch.gather(valid, 1, order)
    qs = torch.where(vs[..., None], s[..., :3], float(_BITS))

    # a new voxel run begins where the sorted coords change
    diff = torch.any(qs[:, 1:] != qs[:, :-1], dim=-1)
    new_voxel = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), diff], 1) & vs
    seg = torch.cumsum(new_voxel.to(torch.int64), dim=1) - 1   # ordinal
    n_vox = torch.sum(new_voxel, dim=1)
    # invalid points and voxels past the capacity go to a scratch row
    seg = torch.where(vs & (seg < capacity), seg, capacity)

    w = vs.to(xyz.dtype)
    vals = torch.cat([s[..., 3:], torch.ones_like(w[..., None])], -1)
    vals = vals * w[..., None]                                 # (B,N,4+D)
    C = 4 + D
    # seg is non-decreasing along each sorted row (invalid points sort
    # last), so the flat slots are runs: summed in place, in sorted order
    flat_idx = (seg + torch.arange(B, device=dev)[:, None]
                * (capacity + 1)).reshape(-1)
    sums = segment_sum(vals.reshape(-1, C),
                       segments(flat_idx, B * (capacity + 1), presorted=True))
    sums = sums.reshape(B, capacity + 1, C)[:, :capacity]
    cnts = sums[..., -1]
    out_valid = (torch.arange(capacity, device=dev)[None, :]
                 < torch.clamp(n_vox, max=capacity)[:, None])
    mean = torch.where(
        out_valid[..., None],
        sums[..., :-1] / torch.clamp(cnts, min=1.0)[..., None], 0.0)
    return mean, out_valid, n_vox.to(torch.int32)


def voxel_downsample(xyz: Tensor, valid: Tensor, leaf: float, capacity: int,
                     with_count: bool = False):
    """Centroid voxel filter.

    Args:
      xyz: (N, 3) points.
      valid: (N,) bool.
      leaf: voxel edge length (metres).
      capacity: fixed output size.
      with_count: also return ``n_vox`` (() int32), the number of
        occupied voxels BEFORE the capacity cut — callers filtering
        world-frame aggregates must count ``max(n_vox - capacity, 0)``
        as saturation: a saturated world-frame filter censors the map at
        an x-plane, and that must be a loud counter, not a silent bug.

    Returns:
      (out_xyz (capacity,3), out_valid (capacity,)[, n_vox]) — one
      centroid per occupied voxel, in voxel-key order; padded with zeros.
      Excess voxels are truncated in key order (monotone in x): for the
      sensor-frame per-scan filters that is a forward-range cap; the
      world-frame capacities are sized never to saturate.
    """
    empty = xyz.new_zeros((1, xyz.shape[0], 0))
    mean, out_valid, n_vox = _downsample_core(
        xyz[None], empty, valid[None], leaf, capacity)
    if with_count:
        return mean[0], out_valid[0], n_vox[0]
    return mean[0], out_valid[0]


def voxel_downsample_with_payload(xyz: Tensor, payload: Tensor, valid: Tensor,
                                  leaf: float, capacity: int):
    """Same as :func:`voxel_downsample` but also averages a per-point payload
    array (N, D) over each voxel (used for ring / rel-time channels).

    Returns (xyz (capacity,3), payload (capacity,D), valid (capacity,))."""
    mean, out_valid, _ = _downsample_core(
        xyz[None], payload[None], valid[None], leaf, capacity)
    return mean[0, :, :3], mean[0, :, 3:], out_valid[0]


def voxel_downsample_with_payload_batched(xyz: Tensor, payload: Tensor,
                                          valid: Tensor, leaf: float,
                                          capacity: int):
    """:func:`voxel_downsample_with_payload` over a leading batch axis
    (B, N, …) in one call — each batch row is filtered on its own."""
    mean, out_valid, _ = _downsample_core(xyz, payload, valid, leaf, capacity)
    return mean[..., :3], mean[..., 3:], out_valid


def voxel_hash_downsample(xyz: Tensor, payload: Tensor, valid: Tensor,
                          leaf: float, capacity: int, salt: Tensor = None,
                          two_probe: bool = True):
    """Scatter-based voxel filter: one *representative point* per occupied
    voxel, slots assigned by spatial hash; distinct voxels can collide.
    With ``two_probe`` points that lose their first slot to a different
    voxel are rescued into a second independent slot.

    Which of several points writing one slot survives is the point with the
    HIGHEST index (made explicit with a scatter-max of point ids, so the
    result does not depend on the order a device applies writes in).

    Returns (xyz (capacity,3), payload (capacity,D), valid (capacity,)).
    Output order is hash-slot order (order-independent consumers only).
    """
    n = xyz.shape[0]
    dev = xyz.device
    q = torch.floor(xyz * recip32(leaf)).to(torch.int32)
    h = (q[..., 0] * 73856093) ^ (q[..., 1] * 19349663) \
        ^ (q[..., 2] * 83492791)
    if salt is not None:
        h = h ^ (salt.to(torch.int32) * -1640531527)           # 0x9E3779B1
    slot = torch.remainder(h & (2 ** 31 - 1), capacity)
    slot = torch.where(valid, slot, capacity)                  # ⇒ scratch
    pid = torch.arange(n, dtype=torch.int32, device=dev)

    def owners(slot_):
        own = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
        own.scatter_reduce_(0, slot_.to(torch.int64), pid, "amax")
        return own

    if two_probe:
        owner = owners(slot)
        got = owner[torch.clamp(slot, 0, capacity - 1).to(torch.int64)] == pid
        h2 = (h * -1640531527) ^ (h >> 13)
        slot2 = torch.remainder(h2 & (2 ** 31 - 1), capacity)
        slot = torch.where(valid & ~got, slot2, slot)

    owner = owners(slot)[:capacity]
    out_valid = owner >= 0
    src = torch.clamp(owner, min=0).to(torch.int64)
    out_xyz = torch.where(out_valid[:, None], xyz[src], 0.0)
    out_payload = torch.where(out_valid[:, None], payload[src], 0.0)
    return out_xyz, out_payload, out_valid

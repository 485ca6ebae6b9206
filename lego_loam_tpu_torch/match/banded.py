"""Banded (per-ring-window) correspondence search for scan-to-scan odometry.

The full-matrix search (``match/bruteforce.py``) scores every query against
every candidate: at HDL-64 the (Q, M) matrices are (2048, 16384) surf and
(1024, 8192) corner — quadratic in beam count, because the feature caps
scale with V on both axes.  But the reference's own correspondence semantics
are ring-local: the 2nd/3rd plane points and the 2nd line point must lie
within ±2.5 rings of the 1-NN's ring (``featureAssociation.cpp:520-565,
656-725``), and the 1-NN of a query is — geometrically — within a couple of
rings of the query's own beam.  So the search only ever needs a *band* of
rings around each query.

Layout: queries and candidates are re-blocked **per ring** into
``(V, cap, …)`` tensors; the candidate band for ring v is the concatenation
of rings ``v−B … v+B`` (2B+1 rolled views, the rings past either end
masked).  The distance work drops from ``Q·M`` to ``Q·(2B+1)·cc``.

Approximation vs the full search (config-gated via
``FeatureConfig.odom_band_rings``; 0 = exact full matrix): a true 1-NN more
than B rings from the query's own ring is missed.  The absolute 5 m gates
here are *exact* (difference-first recompute on the winners), which the
full-matrix path only approximates through the recentred expansion.

Everything here is plain tensor ops: the JAX package computes it outside
any Pallas kernel.  Indices are int64 (the JAX package's are int32).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Container, FeatureCloud

Tensor = torch.Tensor

_INF = 3e38


@dataclasses.dataclass
class RingBlocked(Container):
    """A FeatureCloud re-laid-out as (V, cap) per-ring blocks."""

    xyz: Tensor        # (V, cap, 3)
    ring: Tensor       # (V, cap) float32 (original fractional ring)
    rel_time: Tensor   # (V, cap)
    valid: Tensor      # (V, cap) bool

    def as_cloud(self) -> FeatureCloud:
        """Flattened view usable anywhere a FeatureCloud is."""
        V, C = self.valid.shape
        return FeatureCloud(
            xyz=self.xyz.reshape(V * C, 3), ring=self.ring.reshape(-1),
            rel_time=self.rel_time.reshape(-1),
            valid=self.valid.reshape(-1))


@dataclasses.dataclass
class BandedCandidates(Container):
    """Candidate band tensors: row v holds rings v−B … v+B stacked."""

    xyz: Tensor        # (V, W*cap, 3)
    ring: Tensor       # (V, W*cap)
    valid: Tensor      # (V, W*cap)


def ring_block(cloud: FeatureCloud, num_rings: int, cap: int,
               presorted: bool = True) -> RingBlocked:
    """Gather a compact FeatureCloud into per-ring blocks.

    Slot (r, k) reads row ``start[r] + k`` of the ring-sorted cloud and is
    valid while it stays inside ring r's run; points beyond ``cap`` in a
    ring are dropped (caps are sized to the per-ring pick maxima, so only
    pathological inputs truncate).

    ``presorted``: the pick clouds are ring-sorted by the position-major
    layout contract (valid entries ascending in (ring, col), invalids last),
    so the run starts come from a comparison count with no sort.  Pass False
    for arbitrary layouts to pay one stable sort instead.  Either way, order
    within a ring preserves array position, keeping kNN tie-break order
    pinned.
    """
    N = cloud.valid.shape[0]
    dev = cloud.valid.device
    ring_i = torch.clamp(torch.floor(cloud.ring).to(torch.int64), 0,
                         num_rings - 1)
    seg = torch.where(cloud.valid, ring_i, num_rings)
    if presorted:
        order = None
        seg_s = seg
    else:
        order = torch.sort(seg, stable=True).indices
        seg_s = seg[order]
    bounds = torch.arange(num_rings + 1, device=dev)
    start = torch.sum(seg_s[None, :] < bounds[:, None], dim=1)
    src = start[:num_rings, None] + torch.arange(cap, device=dev)[None, :]
    in_run = src < start[1:, None]
    src_flat = torch.clamp(src.reshape(-1), 0, N - 1)

    packed = torch.cat(
        [cloud.xyz, cloud.ring[:, None], cloud.rel_time[:, None],
         cloud.valid[:, None].to(torch.float32)], dim=1)
    if order is not None:
        src_flat = order[src_flat]
    out = packed[src_flat]
    valid = in_run & (out[:, 5] > 0.5).reshape(num_rings, cap)
    return RingBlocked(
        xyz=out[:, :3].reshape(num_rings, cap, 3),
        ring=out[:, 3].reshape(num_rings, cap),
        rel_time=out[:, 4].reshape(num_rings, cap),
        valid=valid)


def ring_block_from_layout(cloud: FeatureCloud, num_rings: int
                           ) -> RingBlocked:
    """Zero-cost re-view of a cloud whose layout is ALREADY per-ring blocked
    with a fixed per-ring capacity (``frontend/features.py`` builds
    less_flat so, and every pick cloud so when the band is on)."""
    V = num_rings
    cap = cloud.valid.shape[0] // V
    return RingBlocked(
        xyz=cloud.xyz.reshape(V, cap, 3),
        ring=cloud.ring.reshape(V, cap),
        rel_time=cloud.rel_time.reshape(V, cap),
        valid=cloud.valid.reshape(V, cap))


def band(blocked: RingBlocked, half_width: int) -> BandedCandidates:
    """Stack rings v−B … v+B into each row's candidate band: one roll per
    offset and one concatenation, rings past either end masked."""
    V = blocked.valid.shape[0]
    v = torch.arange(V, device=blocked.valid.device)
    xs, rs, ok = [], [], []
    for o in range(-half_width, half_width + 1):
        in_range = ((v + o >= 0) & (v + o < V))[:, None]
        xs.append(torch.roll(blocked.xyz, -o, dims=0))
        rs.append(torch.roll(blocked.ring, -o, dims=0))
        ok.append(torch.roll(blocked.valid, -o, dims=0) & in_range)
    return BandedCandidates(xyz=torch.cat(xs, dim=1),
                            ring=torch.cat(rs, dim=1),
                            valid=torch.cat(ok, dim=1))


def _sqnorm(d: Tensor) -> Tensor:
    """x² + y² + z² over the last axis, summed in that order."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2])


def banded_sqdist(qxyz: Tensor, center: Tensor,
                  cand: BandedCandidates) -> Tensor:
    """(V, qc, 3) × (V, Wc, 3) → (V, qc, Wc) squared distances.

    DIFFERENCE-FIRST (exact float32), not the ``‖a‖²+‖b‖²−2a·b`` expansion:
    banding already cut the matrix ~V/(2B+1)×, so the remaining Q·Wc·3
    elementwise work is small, and difference-first needs no recentring.
    ``center`` is kept for the JAX package's signature but unused.
    """
    del center
    return _sqnorm(qxyz[:, :, None, :] - cand.xyz[:, None, :, :])


def exact_sqdist_to(qxyz: Tensor, picked_xyz: Tensor) -> Tensor:
    """Difference-first exact distances query↔winner (the absolute-gate
    recompute)."""
    return _sqnorm(qxyz - picked_xyz)


def masked_argmin(d2: Tensor, ok: Tensor):
    """Batched masked argmin over the band axis; ties go to the FIRST
    minimum, as ``jnp.argmin`` does.

    d2 (V, qc, Wc), ok (V, 1|qc, Wc) → (idx (V, qc) int64, d2min)."""
    dmin, idx = torch.min(torch.where(ok, d2, _INF), dim=-1)
    return idx, dmin


def gather_band(cand: BandedCandidates, idx: Tensor) -> Tensor:
    """xyz rows of the band picked per query: (V, qc) → (V, qc, 3)."""
    V, qc = idx.shape
    return torch.gather(cand.xyz, 1, idx[..., None].expand(V, qc, 3))

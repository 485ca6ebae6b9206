"""Stage 2a — curvature, occlusion masking, sector top-k feature selection.

Reimplements ``calculateSmoothness`` / ``markOccludedPoints`` /
``extractFeatures`` (``featureAssociation.cpp:200-383``) over the per-ring
compacted ``SegmentedCloud`` (V, S) arrays.

The reference's per-sector sort + sequential greedy pick (with ±5 neighbor
suppression that stops at column gaps > 10) is reproduced as a short loop
of masked argmax picks over all (ring, sector) pairs at once — 20 + 4
sequential steps in total instead of 96 sequential sorts.

With ``odom_band_rings > 0`` the pick clouds ship ring-blocked
(``_blocked_from_picks``) for the banded odometry search
(``match/banded.py``).
"""

from __future__ import annotations

import torch

from ..core.config import LegoLoamConfig
from ..core.types import FeatureCloud, FeatureSet, SegmentedCloud
from ..match.voxelhash import voxel_downsample_with_payload_batched

Tensor = torch.Tensor

_BIG = 1e18


def compute_curvature(seg: SegmentedCloud) -> Tensor:
    """Squared 10-neighbour range difference (``featureAssociation.cpp:
    200-223``): c_j = (Σ_{l=±1..5} r_{j+l} − 10 r_j)²  per ring row."""
    r = torch.where(seg.valid, seg.rng, 0.0)
    acc = -10.0 * r
    for l in range(1, 6):
        acc = acc + torch.roll(r, l, dims=1) + torch.roll(r, -l, dims=1)
    return acc * acc


def occlusion_mask(seg: SegmentedCloud, cfg: LegoLoamConfig) -> Tensor:
    """Initial neighbor-picked mask (``markOccludedPoints``,
    ``featureAssociation.cpp:226-262``): occlusion boundaries (range jump
    > 0.3 m within 10 columns → 6 far-side points masked) plus isolated
    points (both neighbors differ > 2 % of range)."""
    f = cfg.feature
    r = seg.rng
    col = seg.col
    v = seg.valid

    d1 = r                                   # depth at j
    d2 = torch.roll(r, -1, dims=1)           # depth at j+1
    col_diff = torch.abs(torch.roll(col, -1, dims=1) - col)
    pair_ok = v & torch.roll(v, -1, dims=1) & (col_diff < f.occlusion_col_diff)

    far_is_left = pair_ok & (d1 - d2 > f.occlusion_range_jump)   # mask j-5..j
    far_is_right = pair_ok & (d2 - d1 > f.occlusion_range_jump)  # mask j+1..j+6

    picked = torch.zeros_like(v)
    for l in range(0, 6):                 # flag at j masks positions j-5..j
        picked = picked | torch.roll(far_is_left, -l, dims=1)
    for l in range(1, 7):                 # flag at j masks positions j+1..j+6
        picked = picked | torch.roll(far_is_right, l, dims=1)

    prev_diff = torch.abs(torch.roll(r, 1, dims=1) - r)
    next_diff = torch.abs(torch.roll(r, -1, dims=1) - r)
    isolated = v & (prev_diff > 0.02 * r) & (next_diff > 0.02 * r)
    return (picked | isolated) & v


def _floordiv(a: Tensor, b: int) -> Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _sector_bounds(count: Tensor, num_sectors: int, guard: int = 5):
    """Per-(ring, sector) inclusive index bounds [sp, ep], matching
    ``featureAssociation.cpp:274-281`` with the ±5 guard bands baked into
    startRingIndex/endRingIndex (``imageProjection.cpp:362,397``)."""
    start = torch.full_like(count, guard - 1)        # local startRingIndex
    end = count - 1 - guard                          # local endRingIndex
    k = torch.arange(num_sectors, dtype=count.dtype, device=count.device)
    sp = _floordiv(start[:, None] * (num_sectors - k) + end[:, None] * k,
                   num_sectors)
    ep = _floordiv(start[:, None] * (num_sectors - 1 - k)
                   + end[:, None] * (k + 1), num_sectors) - 1
    return sp, ep


def _gap_prefix(col: Tensor, valid: Tensor, max_gap: int) -> Tensor:
    """Per-ring prefix count of column gaps > ``max_gap``.  The
    reference's ±5 suppression walk breaks at the first such gap
    (``featureAssociation.cpp:306-326``); with this prefix sum the break
    condition becomes simply ``badcum[p] == badcum[idx]``."""
    gap = torch.abs(col - torch.roll(col, 1, dims=1))
    bad = (gap > max_gap) | ~valid
    bad[:, 0] = False
    return torch.cumsum(bad.to(torch.int32), dim=1)


def _greedy_pick(score: Tensor, eligible0: Tensor, picked0: Tensor,
                 badcum: Tensor, n_picks: int, maximize: bool,
                 cfg: LegoLoamConfig):
    """Run ``n_picks`` rounds of (argbest over each ring×sector, mark,
    suppress ±5 neighbours up to the first column gap).  ``argmax`` /
    ``argmin`` return the first extremum, so ties resolve to the lower
    position.  Returns (pick one-hots (n_picks, V, K, S) in rank order,
    idxs (n_picks, V, K), have (n_picks, V, K), picked)."""
    del cfg
    V, K, S = eligible0.shape
    pos = torch.arange(S, device=score.device)
    fill = -_BIG if maximize else _BIG

    picked = picked0
    onehots, idxs, have = [], [], []
    for _ in range(n_picks):
        elig = eligible0 & ~picked[:, None, :]
        s = torch.where(elig, score[:, None, :], fill)
        idx = (torch.argmax(s, dim=-1) if maximize
               else torch.argmin(s, dim=-1))                   # (V,K)
        has = torch.any(elig, dim=-1)                          # (V,K)

        bc_idx = torch.gather(badcum, 1, idx)                  # (V,K)
        near = torch.abs(pos[None, None, :] - idx[:, :, None]) <= 5
        same_run = badcum[:, None, :] == bc_idx[:, :, None]
        sup = near & same_run & has[:, :, None]                # (V,K,S)
        one_hot = (pos[None, None, :] == idx[:, :, None]) & has[:, :, None]
        picked = picked | torch.any(sup, dim=1)
        onehots.append(one_hot)
        idxs.append(idx)
        have.append(has)
    return (torch.stack(onehots), torch.stack(idxs), torch.stack(have),
            picked)


def _cloud_from_picks(seg: SegmentedCloud, idxs: Tensor, have: Tensor,
                      capacity: int) -> FeatureCloud:
    """Build a FeatureCloud by gathering the ~R·V·K pick indices that
    :func:`_greedy_pick` already computed.

    idxs/have: (R, V, K) pick column + validity per (rank, ring, sector).
    """
    R, V, K = idxs.shape
    S = seg.rng.shape[1]
    dev = idxs.device
    ring = torch.arange(V, device=dev)[None, :, None].expand(R, V, K)
    flat = (ring * S + torch.clamp(idxs, 0, S - 1)).reshape(-1)
    ok = have.reshape(-1)

    # left-compact in flat-pixel order — bit-identical layout to a
    # position-major mask compaction (the trajectory is chaotically
    # sensitive even to candidate ORDER via kNN tie-breaks, so the
    # layout is pinned, not left to rank order).  The sort must be
    # STABLE: the invalid entries share one key and keep their order.
    n = R * V * K
    key = torch.where(ok, flat, 2 ** 30)
    order = torch.sort(key, stable=True).indices
    flat, ok = flat[order], ok[order]

    xyz = seg.xyz.reshape(-1, 3)[flat]
    rel = seg.rel_time.reshape(-1)[flat]
    ring_f = _floordiv(flat, S).to(torch.float32)

    if n >= capacity:                       # static truncation
        xyz, rel, ring_f, ok = (xyz[:capacity], rel[:capacity],
                                ring_f[:capacity], ok[:capacity])
    else:
        pad = capacity - n
        xyz = torch.cat([xyz, xyz.new_zeros((pad, 3))])
        rel = torch.cat([rel, rel.new_zeros((pad,))])
        ring_f = torch.cat([ring_f, ring_f.new_zeros((pad,))])
        ok = torch.cat([ok, ok.new_zeros((pad,))])
    return FeatureCloud(
        xyz=torch.where(ok[:, None], xyz, 0.0), ring=ring_f,
        rel_time=torch.where(ok, rel, 0.0), valid=ok)


def _blocked_from_picks(seg: SegmentedCloud, idxs: Tensor, have: Tensor,
                        capacity: int) -> FeatureCloud:
    """Ring-BLOCKED variant of :func:`_cloud_from_picks` for the banded
    odometry search (``match/banded.py``): ring v's picks land in rows
    ``[v·cap, (v+1)·cap)`` with cap = capacity // V (= n_picks·sectors,
    the per-ring pick maximum, so nothing truncates).  Within a ring,
    picks are sorted by column position with invalids last — the same
    within-ring order as the position-major compact layout, keeping kNN
    tie-break order equivalent.  The sort must be STABLE, as
    ``jnp.argsort`` is: the invalid entries share one key."""
    R, V, K = idxs.shape
    S = seg.rng.shape[1]
    cap = capacity // V
    assert cap == R * K, (capacity, V, R, K)

    idx_vr = idxs.transpose(0, 1).reshape(V, R * K)          # (V, R*K)
    ok_vr = have.transpose(0, 1).reshape(V, R * K)
    key = torch.where(ok_vr, idx_vr, 2 ** 30)
    order = torch.sort(key, dim=1, stable=True).indices
    idx_s = torch.gather(idx_vr, 1, order)
    ok = torch.gather(ok_vr, 1, order).reshape(-1)

    rings = torch.arange(V, device=idxs.device)[:, None].expand(V, R * K)
    flat = (rings * S + torch.clamp(idx_s, 0, S - 1)).reshape(-1)
    xyz = seg.xyz.reshape(-1, 3)[flat]
    rel = seg.rel_time.reshape(-1)[flat]
    return FeatureCloud(
        xyz=torch.where(ok[:, None], xyz, 0.0),
        ring=rings.reshape(-1).to(torch.float32),
        rel_time=torch.where(ok, rel, 0.0), valid=ok)


def extract_features(seg: SegmentedCloud, cfg: LegoLoamConfig) -> FeatureSet:
    """Full feature extraction (``extractFeatures``,
    ``featureAssociation.cpp:265-383``)."""
    f = cfg.feature
    V, S = seg.rng.shape
    K = f.num_sectors
    dev = seg.rng.device

    curv = compute_curvature(seg)
    picked0 = occlusion_mask(seg, cfg)
    badcum = _gap_prefix(seg.col, seg.valid, f.occlusion_col_diff)

    sp, ep = _sector_bounds(seg.count, K)             # (V,K)
    pos = torch.arange(S, device=dev)
    sector = ((pos[None, None, :] >= sp[:, :, None])
              & (pos[None, None, :] <= ep[:, :, None])
              & (sp < ep)[:, :, None])                # (V,K,S)
    base_ok = seg.valid[:, None, :] & sector

    # --- corner picks: top-20 curvature, non-ground, curv > edge_threshold
    corner_elig = (base_ok & ~seg.is_ground[:, None, :]
                   & (curv > f.edge_threshold)[:, None, :])
    corner_oh, corner_idx, corner_has, picked = _greedy_pick(
        curv, corner_elig, picked0, badcum, f.less_sharp_per_sector,
        maximize=True, cfg=cfg)
    less_sharp_mask = torch.any(torch.any(corner_oh, dim=2), dim=0)

    # --- flat picks: 4 smallest-curvature ground points, curv < threshold
    flat_elig = (base_ok & seg.is_ground[:, None, :]
                 & (curv < f.surf_threshold)[:, None, :])
    _, flat_idx, flat_has, picked = _greedy_pick(
        curv, flat_elig, picked, badcum, f.flat_per_sector,
        maximize=False, cfg=cfg)

    # --- less-flat: every in-sector point not labeled corner (:370-377)
    in_any_sector = torch.any(sector, dim=1) & seg.valid
    less_flat_src = in_any_sector & ~less_sharp_mask

    rings = torch.arange(V, device=dev)[:, None].expand(V, S)

    # per-ring 0.2 m voxel downsample of the less-flat scan (:379-382).
    # Exact sort-based centroids, deliberately: these points are both the
    # odometry plane candidates and (via AssociationOut) the keyframe
    # surf clouds, and pcl::VoxelGrid's noise-averaging centroids proved
    # load-bearing for accuracy on long runs.
    per_ring_cap = cfg.feature.max_less_flat // V
    payload = torch.stack(
        [rings.to(torch.float32), seg.rel_time], dim=-1)      # (V,S,2)
    ds_xyz, ds_payload, ds_valid = voxel_downsample_with_payload_batched(
        seg.xyz, payload, less_flat_src, f.surf_leaf_size, per_ring_cap)
    less_flat = FeatureCloud(
        xyz=ds_xyz.reshape(-1, 3),
        ring=ds_payload[..., 0].reshape(-1),
        rel_time=ds_payload[..., 1].reshape(-1),
        valid=ds_valid.reshape(-1))

    if f.odom_band_rings > 0:
        # banded odometry (match/banded.py): the pick clouds ship
        # ring-blocked so the solver re-views them for free; requires the
        # capacities to be exactly V·picks·sectors (asserted in
        # _blocked_from_picks)
        return FeatureSet(
            sharp=_blocked_from_picks(seg,
                                      corner_idx[:f.sharp_per_sector],
                                      corner_has[:f.sharp_per_sector],
                                      f.max_sharp),
            less_sharp=_blocked_from_picks(seg, corner_idx, corner_has,
                                           f.max_less_sharp),
            flat=_blocked_from_picks(seg, flat_idx, flat_has, f.max_flat),
            less_flat=less_flat)
    return FeatureSet(
        sharp=_cloud_from_picks(seg, corner_idx[:f.sharp_per_sector],
                                corner_has[:f.sharp_per_sector],
                                f.max_sharp),
        less_sharp=_cloud_from_picks(seg, corner_idx, corner_has,
                                     f.max_less_sharp),
        flat=_cloud_from_picks(seg, flat_idx, flat_has, f.max_flat),
        less_flat=less_flat)

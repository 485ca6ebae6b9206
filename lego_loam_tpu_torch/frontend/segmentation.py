"""Stage 1b — range-image cluster segmentation.

The reference grows clusters with a per-seed BFS over the range image
(``labelComponents``, ``imageProjection.cpp:412-496``).  We compute the
identical connected components from precomputed adjacency edges of the
LeGO-LOAM merge criterion

    tan(β) = d₂·sin α / (d₁ − d₂·cos α)  >  tan(segment_theta)

(``imageProjection.cpp:457-465``; symmetric in the two pixels, so BFS
reachability == undirected connected components).  Every pixel's label is
the minimum flat index of its component; ``frontend/cuda_label.py`` computes
it — with a union-find CUDA kernel on the card, with a fixed-point min-label
flood in tensor ops on the CPU.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..core import graphs
from ..core.config import LegoLoamConfig
from ..core.types import ProjectionOut, RangeImage, RawScan, SegmentedCloud
from .cuda_label import SENTINEL, propagate_labels
from .projection import project_scan, virtual_scan_2d

Tensor = torch.Tensor


def _edge_masks(img: RangeImage, cfg: LegoLoamConfig):
    """Connectivity masks.  ``right[i,j]`` ⇔ (i,j)↔(i,j+1 mod H) merge,
    ``down[i,j]`` ⇔ (i,j)↔(i+1,j) merge.  Only non-ground valid pixels
    participate (ground/invalid pixels get label −1 in the reference,
    ``imageProjection.cpp:293-300``)."""
    laser = cfg.laser
    theta = math.tan(math.radians(cfg.projection.segment_theta_deg))
    segmentable = img.valid & ~img.ground

    def merge(r_a, r_b, alpha):
        d1 = torch.maximum(r_a, r_b)
        d2 = torch.minimum(r_a, r_b)
        tang = d2 * math.sin(alpha) / (d1 - d2 * math.cos(alpha))
        return tang > theta

    r = img.rng
    right = (segmentable & torch.roll(segmentable, -1, dims=1)
             & merge(r, torch.roll(r, -1, dims=1), laser.ang_res_x))
    down = torch.zeros_like(segmentable)
    down[:-1] = (segmentable[:-1] & segmentable[1:]
                 & merge(r[:-1], r[1:], laser.ang_res_y))
    return segmentable, right, down


def _label_inputs(img: RangeImage, cfg: LegoLoamConfig):
    """(segmentable, labels0, right, down): the labelling's inputs, with
    ``labels0`` the flat pixel index on segmentable pixels and the sentinel
    elsewhere."""
    segmentable, right, down = _edge_masks(img, cfg)
    V, H = segmentable.shape
    flat = torch.arange(V * H, dtype=torch.int32,
                        device=segmentable.device).reshape(V, H)
    labels0 = torch.where(segmentable, flat, SENTINEL)
    return segmentable, labels0, right, down


def label_components(img: RangeImage, cfg: LegoLoamConfig):
    """Connected components under the merge criterion.

    Returns ``(labels, segmentable)`` where ``labels[i,j]`` is the min flat
    index of the pixel's component (sentinel where not segmentable).
    """
    segmentable, labels0, right, down = _label_inputs(img, cfg)
    labels = propagate_labels(labels0, right, down,
                              max_sweeps=cfg.projection.max_label_iters)
    return labels, segmentable


def segment_validity(labels: Tensor, segmentable: Tensor,
                     cfg: LegoLoamConfig) -> Tensor:
    """Per-pixel flag: pixel belongs to a *valid* segment.

    Validity rule (``imageProjection.cpp:477-487``): ≥30 points, or
    ≥``segment_valid_point_num`` points spanning ≥``segment_valid_line_num``
    distinct rings.
    """
    V, H = labels.shape
    n = V * H
    dev = labels.device
    seg_id = torch.where(segmentable, labels, n).reshape(-1).to(torch.int64)
    ones = segmentable.to(torch.int32).reshape(-1)

    # one scatter-add into a flat (segment, ring) table; non-segmentable
    # pixels land in the extra row n and add 0
    rows = torch.arange(V, device=dev)[:, None].expand(V, H).reshape(-1)
    acc = torch.zeros(((n + 1) * V,), dtype=torch.int32, device=dev)
    acc.index_add_(0, seg_id * V + rows, ones)
    acc = acc.reshape(n + 1, V)
    sizes = torch.sum(acc, dim=-1)
    lines = torch.sum(acc > 0, dim=-1)

    p = cfg.projection
    ok = (sizes >= p.segment_min_point_num) | (
        (sizes >= p.segment_valid_point_num)
        & (lines >= p.segment_valid_line_num))
    return ok[torch.clamp(seg_id, 0, n)].reshape(V, H) & segmentable


def _relative_time(img: RangeImage) -> Tensor:
    """Intra-scan relative time ∈ [0,1) per pixel from azimuth
    (``adjustDistortion``, ``featureAssociation.cpp:161-197``).  Uses a
    modular unwrap instead of the reference's half-pass state machine —
    equivalent for diff ≈ 2π, clamped otherwise."""
    ori = -torch.arctan2(img.xyz[..., 1], img.xyz[..., 0])
    diff = img.end_orientation - img.start_orientation
    rel = torch.remainder(ori - img.start_orientation, 2.0 * math.pi) / diff
    return torch.clamp(rel, 0.0, 1.0)


def _compact_rows(include: Tensor, fields: dict, capacity: int,
                  extra_include: Optional[Tensor] = None,
                  extra_capacity: int = 0):
    """Left-compact each row of (V,H) arrays by ``include``, preserving
    column order.  Returns compacted fields + per-row counts.

    All fields are packed into one (VH, C) float32 payload and moved with a
    SINGLE indexed write (destination = row·capacity + per-row rank);
    pixels that are not kept write to one scratch row past the end.

    ``extra_include`` (disjoint from ``include``) rides the SAME write
    into a trailing ``extra_capacity``-row block, compacted globally in
    flat pixel order.  Returns the extra block as a dict unpacked
    per-field (same keys/dtypes as ``fields``) + its count."""
    V, H = include.shape
    dev = include.device
    count = torch.sum(include, dim=1).to(torch.int32)
    pos = torch.cumsum(include, dim=1) - 1                  # per-row rank
    rows = torch.arange(V, device=dev)[:, None].expand(V, H)
    total = V * capacity + extra_capacity
    dest = torch.where(include & (pos < capacity),
                       rows * capacity + pos, total).reshape(-1)  # ⇒ scratch
    if extra_include is not None:
        eflat = extra_include.reshape(-1)
        epos = torch.cumsum(eflat, dim=0) - 1
        dest = torch.where(eflat & (epos < extra_capacity),
                           V * capacity + epos, dest)

    packed, splits, shapes = [], [], {}
    for k, v in fields.items():
        flat = v.reshape(V * H, -1).to(torch.float32)
        shapes[k] = (v.dtype, tuple(v.shape[2:]) if v.dim() > 2 else ())
        splits.append(flat.shape[1])
        packed.append(flat)
    payload = torch.cat(packed, dim=1)                      # (VH, C)
    gathered = torch.zeros((total + 1, payload.shape[1]),
                           dtype=torch.float32, device=dev)
    gathered[dest] = payload        # kept destinations are unique
    extra_block = gathered[V * capacity:total]
    gathered = gathered[:V * capacity].reshape(V, capacity, -1)

    out, off = {}, 0
    for k, w in zip(fields.keys(), splits):
        dtype, tail = shapes[k]
        g = gathered[:, :, off:off + w]
        out[k] = (g.reshape((V, capacity) + tail) if tail
                  else g[:, :, 0]).to(dtype)
        off += w
    pos_c = torch.arange(capacity, device=dev)[None, :]
    valid = pos_c < count[:, None]
    if extra_include is None:
        return out, count, valid
    # unpack the extra block with the same splits/shapes machinery so a
    # reordered or widened fields dict cannot silently misalign it
    extra_out, off = {}, 0
    for k, w in zip(fields.keys(), splits):
        dtype, tail = shapes[k]
        g = extra_block[:, off:off + w]
        extra_out[k] = (g.reshape((extra_capacity,) + tail) if tail
                        else g[:, 0]).to(dtype)
        off += w
    extra_count = torch.sum(extra_include).to(torch.int32)
    return out, count, valid, extra_out, extra_count


def segment_cloud(img: RangeImage, raw_stamp: Tensor,
                  cfg: LegoLoamConfig) -> ProjectionOut:
    """Full stage-1b: label, validate, and flatten into the per-ring
    segmented cloud + outlier cloud (``cloudSegmentation``,
    ``imageProjection.cpp:352-409``)."""
    labels, segmentable = label_components(img, cfg)
    return _segment_labelled(img, labels, segmentable, raw_stamp, cfg)


def _segment_labelled(img: RangeImage, labels: Tensor, segmentable: Tensor,
                      raw_stamp: Tensor, cfg: LegoLoamConfig
                      ) -> ProjectionOut:
    """Stage 1b after the labelling: validate the segments and flatten."""
    V, H = img.rng.shape
    dev = img.rng.device
    G = cfg.laser.ground_scan_index
    dec = cfg.projection.ground_decimation

    seg_ok = segment_validity(labels, segmentable, cfg)

    cols = torch.arange(H, dtype=torch.int32, device=dev)[None, :].expand(V, H)
    rows = torch.arange(V, dtype=torch.int32, device=dev)[:, None].expand(V, H)

    ground_keep = img.ground & (
        (cols % dec == 0) | (cols <= dec) | (cols >= H - dec))
    include = seg_ok | ground_keep
    outlier_px = (segmentable & ~seg_ok & (rows > G) & (cols % dec == 0))

    rel = _relative_time(img)
    # outlier pixels (above-ground invalid segments) are DISJOINT from
    # ``include`` (seg_ok ∨ ground), so they ride the same write into a
    # trailing block.
    O = cfg.pipeline.max_outlier
    fields, count, valid, extra_fields, out_count = _compact_rows(
        include,
        dict(xyz=img.xyz, rng=img.rng, col=cols,
             ground=img.ground, rel=rel),
        capacity=H, extra_include=outlier_px, extra_capacity=O)

    segmented = SegmentedCloud(
        xyz=fields["xyz"], rng=fields["rng"], col=fields["col"],
        is_ground=fields["ground"], valid=valid, count=count,
        rel_time=fields["rel"])

    out_xyz = extra_fields["xyz"]
    out_valid = torch.arange(O, device=dev) < out_count

    scan2d_xyz, scan2d_valid = virtual_scan_2d(img, cfg)

    return ProjectionOut(
        segmented=segmented,
        outlier_xyz=torch.where(out_valid[:, None], out_xyz, 0.0),
        outlier_valid=out_valid,
        scan2d_xyz=scan2d_xyz, scan2d_valid=scan2d_valid,
        stamp=raw_stamp)


def _project_and_edges(raw: RawScan, cfg: LegoLoamConfig):
    """Stage 1 up to the labelling, one chain: the range image and the
    labelling's inputs (:func:`_label_inputs`)."""
    img = project_scan(raw, cfg)
    return (img,) + _label_inputs(img, cfg)


def _project_and_edges_batched(raws: Sequence[RawScan],
                               cfg: LegoLoamConfig):
    """:func:`_project_and_edges` of B scans, one chain: the B images and
    segmentable masks, and the labelling's inputs stacked (B, V, H)."""
    parts = [_project_and_edges(raw, cfg) for raw in raws]
    return ([p[0] for p in parts], [p[1] for p in parts],
            *(torch.stack([p[k] for p in parts]) for k in (2, 3, 4)))


def _segment_labelled_batched(imgs: Sequence[RangeImage], labels: Tensor,
                              segmentables: Sequence[Tensor],
                              stamps: Sequence[Tensor], cfg: LegoLoamConfig
                              ) -> List[ProjectionOut]:
    """:func:`_segment_labelled` of B images, one chain."""
    return [_segment_labelled(img, lab, seg, stamp, cfg)
            for img, lab, seg, stamp in zip(imgs, labels, segmentables,
                                            stamps)]


def image_projection(raw: RawScan, cfg: LegoLoamConfig) -> ProjectionOut:
    """The complete stage-1 entry point (= ``ImageProjection::cloudHandler``,
    ``imageProjection.cpp:153-174``).

    On the card two chains replay from CUDA graphs (``core/graphs.py``):
    projection and edge masks, then segment validity, compaction and the 2D
    scan.  K1 runs eagerly between them, through the module attribute
    ``propagate_labels``, looked up at each call.  The result is owned: it
    shares no storage with a graph's buffers."""
    img, segmentable, labels0, right, down = graphs.run(
        _project_and_edges, raw, cfg)
    labels = propagate_labels(labels0, right, down,
                              max_sweeps=cfg.projection.max_label_iters)
    return graphs.owned(graphs.run(_segment_labelled, img, labels,
                                   segmentable, raw.stamp, cfg))


def image_projection_batched(raws: Sequence[RawScan], cfg: LegoLoamConfig
                             ) -> List[ProjectionOut]:
    """Stage 1 for the scans of B streams at one lock-step: B
    ``ProjectionOut``s, each equal to :func:`image_projection` of its scan.
    The labelling runs once for all B range images — on the card ONE kernel
    launch (``frontend/cuda_label.py``); projection, edge masks, segment
    validity and compaction run per stream (they reduce and scatter within
    one image, and a flattened batch would mix the streams' sums), inside
    the same two chains for all B, so that one replay serves every stream
    and no stream's results overwrite another's."""
    imgs, segmentables, labels0, right, down = graphs.run(
        _project_and_edges_batched, raws, cfg)
    labels = propagate_labels(labels0, right, down,
                              max_sweeps=cfg.projection.max_label_iters)
    return graphs.owned(graphs.run(
        _segment_labelled_batched, imgs, labels, segmentables,
        [raw.stamp for raw in raws], cfg))

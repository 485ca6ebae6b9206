"""Full-pipeline orchestration — the deterministic replay loop.

Replaces the reference's main program + channels + threads (``main.cpp:37-102``,
``channel.h``): the whole 4-stage pipeline is one per-scan step function
over a single ``SlamState``, and offline replay is a Python loop over it.
:func:`batched_replay` runs B independent streams lock-step on one device
(stage 1 of all B scans of a step at once: one labelling-kernel launch);
``distributed/mesh.py::replay_sharded`` spreads streams over a mesh.

Cadence: odometry every scan; mapping every ``mapping_frequency_divider``
scans (``featureAssociation.cpp:1432-1448``), decided on the host from the
scan index (a plain Python ``int`` in this port's ``SlamState``); the fused
10 Hz output pose (stage 4) is emitted every scan.

Every entry point takes ``device=None`` meaning the CUDA card and raises if
there is none; pass ``device="cpu"`` to run on the CPU.  A state keeps the
device it was created on.  The keyframe cloud blocks of the state passed in
are updated IN PLACE (``graph/keyframes.py``); everything else is
functional.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.config import LegoLoamConfig
from ..core.device import DeviceLike, resolve_device, stage
from ..core.types import Container, RawScan
from ..frontend.segmentation import image_projection, image_projection_batched
from ..graph import keyframes
from . import mapping as mapping_mod
from . import odometry as odometry_mod

Tensor = torch.Tensor


@dataclasses.dataclass
class SlamState(Container):
    odo: odometry_mod.OdometryState
    mapping: mapping_mod.MappingState
    scan_index: int          # host-side: decides the mapping cadence


def init_state(cfg: LegoLoamConfig, device: DeviceLike = None,
               mesh=None) -> SlamState:
    """A fresh state on ``device``; with ``mesh`` its keyframe cloud blocks
    are row-sharded over the mesh (``graph/keyframes.py::RowShards``)."""
    device = resolve_device(device)
    return SlamState(
        odo=odometry_mod.init_state(cfg, device),
        mapping=mapping_mod.init_state(cfg, device, mesh),
        scan_index=0)


def _check_device(state: SlamState, device: torch.device) -> None:
    have = state.odo.odom.device
    if have.type != device.type or (
            device.index is not None and have.index != device.index):
        raise ValueError(f"state lives on {have}, but device={device} was "
                         f"asked for")


def mapping_due(scan_index: int, cfg: LegoLoamConfig) -> bool:
    """Whether scan ``scan_index`` (counted from 0) runs a mapping cycle."""
    divider = cfg.mapping.mapping_frequency_divider
    return ((scan_index % divider) == (divider - 1)
            and not cfg.pipeline.odometry_only)


def _place(state: SlamState, mesh) -> SlamState:
    """``state`` with its keyframe cloud blocks row-sharded over ``mesh``
    (``graph/keyframes.py::place_clouds``: the blocks as they are if they
    already are)."""
    clouds = keyframes.place_clouds(state.mapping.clouds, mesh)
    return state.replace(mapping=state.mapping.replace(clouds=clouds))


def slam_step(state: SlamState, raw: RawScan, cfg: LegoLoamConfig,
              device: DeviceLike = None, mesh=None):
    """Process one scan through the full pipeline.

    The state's keyframe blocks decide the single-stream sharded mode, as
    in the JAX package: row-sharded over a mesh
    (``graph/keyframes.py::RowShards``), the submap, loop and rebuild
    gathers read every shard, and the loop-closure re-solve runs
    factor-sharded over that mesh (``distributed/sharded_pgo.py``).
    ``mesh``: optional ``distributed/mesh.py::Mesh`` the blocks are placed
    on first if they are not (:func:`_place`).  The placement changes no
    result.  Independent multi-stream data parallelism is
    ``distributed/mesh.py::replay_sharded`` instead.

    Returns (new_state, outputs) where outputs carries:
      odom  — integrated scan-to-scan odometry pose (10 Hz),
      fused — drift-corrected pose (stage-4 output, 10 Hz),
      mapped — latest mapping pose (updates at 2 Hz),
      kf_count / factor_count — per-scan observability counters,
      loop_diag — (8,) diagnostics of this scan's loop-closure attempt
        ([attempted, accepted, fitness, corr_trans, corr_rot, old_idx,
        latest_idx, re-solved/implausible]; zeros without one).
    """
    device = resolve_device(device)
    _check_device(state, device)
    if raw.xyz.device != state.odo.odom.device:
        raise ValueError(f"scan lives on {raw.xyz.device}, state on "
                         f"{state.odo.odom.device}")

    if mesh is not None:
        state = _place(state, mesh)

    with stage("projection", device):
        proj = image_projection(raw, cfg)
    return _step_projected(state, proj, cfg, device,
                           mapping_due(state.scan_index, cfg))


def _step_projected(state: SlamState, proj, cfg: LegoLoamConfig,
                    device: torch.device, run_mapping: bool):
    """:func:`slam_step` after stage 1: odometry, the mapping cycle when
    ``run_mapping``, fusion."""
    with stage("odometry", device):
        odo_state, assoc = odometry_mod.odometry_step(state.odo, proj, cfg)

    clouds = state.mapping.clouds
    if run_mapping:
        with stage("mapping", device):
            meta, row, mapped, loop_diag = mapping_mod.mapping_step(
                state.mapping.meta, clouds, assoc, cfg)
            clouds = keyframes.apply_row(clouds, row)
    else:
        meta = state.mapping.meta
        mapped = meta.aft_mapped
        loop_diag = torch.zeros((8,), dtype=torch.float32,
                                device=mapped.device)
    map_state = mapping_mod.MappingState(meta=meta, clouds=clouds)

    fused = mapping_mod.fuse_pose(map_state, assoc.odom)

    # Re-anchor the odometry integration to the mapped pose after every
    # mapping cycle.  The integrated odometry pose is only ever consumed
    # RELATIVE to ``bef_mapped`` (predict_pose/fuse_pose compose
    # ``aft ∘ rel(bef, odom)``), so this changes nothing mathematically —
    # but an unanchored Euler integration random-walks its attitude
    # without bound and the pitch=±90° gimbal singularity is an ABSORBING
    # state of compose∘matrix_to_rpy.  Map-anchored attitude stays near
    # truth, so the singularity is unreachable.  In odometry-only mode
    # nothing runs mapping and the stream stays the pure integration
    # (reference semantics).
    if run_mapping:
        odo_state = odo_state.replace(odom=mapped)
        map_state = map_state.replace(
            meta=map_state.meta.replace(bef_mapped=mapped))

    new_state = SlamState(odo=odo_state, mapping=map_state,
                          scan_index=state.scan_index + 1)
    outputs = {
        "odom": assoc.odom,
        "fused": fused,
        "mapped": mapped,
        "kf_count": meta.kf_count,
        "factor_count": meta.factor_count,
        "loop_diag": loop_diag,
    }
    return new_state, outputs


def replay_from(state: SlamState, xyz: Tensor, valid: Tensor, times: Tensor,
                cfg: LegoLoamConfig, device: DeviceLike = None, mesh=None):
    """Resume replay from an existing :class:`SlamState`.

    The chunked long-sequence and resume entry point: the
    per-scan step only ever reads one scan, so the host can feed
    fixed-shape CHUNKS and carry the state across calls.  Equal to one
    whole-sequence :func:`replay` by construction (same step function).

    Args: batched scans (N, P*3) / (N, P) / (N,) from
    ``io.npz_io.pack_sequence`` on the state's device; ``mesh`` as for
    :func:`slam_step` (the state is placed on it once, before the first
    scan).

    Returns (final_state, outputs dict of stacked per-scan tensors).
    """
    device = resolve_device(device)
    if mesh is not None:
        state = _place(state, mesh)
    outs = []
    for i in range(xyz.shape[0]):
        raw = RawScan(xyz=xyz[i].reshape(-1, 3), valid=valid[i],
                      stamp=times[i])
        state, out = slam_step(state, raw, cfg, device=device)
        outs.append(out)
    if not outs:
        return state, {}
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def replay(xyz: Tensor, valid: Tensor, times: Tensor, cfg: LegoLoamConfig,
           device: DeviceLike = None, mesh=None):
    """Offline whole-sequence replay from a fresh state on ``device``;
    ``mesh`` as for :func:`slam_step` (the blocks are made sharded).

    Returns (final_state, outputs dict of (N, …) tensors)."""
    device = resolve_device(device)
    return replay_from(init_state(cfg, device, mesh), xyz, valid, times,
                       cfg, device=device)


def batched_replay(xyz: Tensor, valid: Tensor, times: Tensor,
                   cfg: LegoLoamConfig, device: DeviceLike = None):
    """Replay B independent sequences LOCK-STEP on one device — the
    multi-session throughput mode.

    At each step stage 1 runs for the B scans at once
    (``frontend/segmentation.py::image_projection_batched``: ONE launch of
    the labelling kernel for all B range images).  The mapping cadence
    depends only on the step index, which the streams share, so the decision
    is made once a step; then each stream's odometry, mapping cycle (loop
    attempts, ICP and re-solves with their host reads included) and fusion
    run as in :func:`slam_step`.  Each stream's result is its own
    :func:`replay`'s: on the CPU bit for bit.

    Args: (B, N, P*3) / (B, N, P) / (B, N) on ``device``.

    Returns (final_states, outputs): ``final_states`` is a list of B
    ``SlamState``s (``final_states[b]`` is stream b's); ``outputs`` the
    dict of :func:`replay`, each (B, N, …), batch-major.
    """
    device = resolve_device(device)
    if xyz.dim() != 3:
        raise ValueError(f"xyz must be (B, N, P*3), got {tuple(xyz.shape)}")
    B, N = xyz.shape[:2]
    states: List[SlamState] = [init_state(cfg, device) for _ in range(B)]
    if xyz.device != states[0].odo.odom.device:
        raise ValueError(f"scans live on {xyz.device}, the states on "
                         f"{states[0].odo.odom.device}")
    per_stream: List[list] = [[] for _ in range(B)]
    for i in range(N):
        raws = [RawScan(xyz=xyz[b, i].reshape(-1, 3), valid=valid[b, i],
                        stamp=times[b, i]) for b in range(B)]
        with stage("projection", device):
            projs = image_projection_batched(raws, cfg)
        run_mapping = mapping_due(i, cfg)
        for b in range(B):
            states[b], out = _step_projected(states[b], projs[b], cfg,
                                             device, run_mapping)
            per_stream[b].append(out)
    if N == 0:
        return states, {}
    keys = per_stream[0][0].keys()
    return states, {k: torch.stack([torch.stack([o[k] for o in outs])
                                    for outs in per_stream]) for k in keys}

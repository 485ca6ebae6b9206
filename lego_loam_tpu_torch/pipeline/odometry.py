"""Per-scan odometry stage — the ``runFeatureAssociation`` loop body
(``featureAssociation.cpp:1386-1450``) as one step function.

The reference's FA thread state (last clouds, KD-trees, transformCur,
transformSum) is an explicit ``OdometryState`` threaded through the replay
loop; a step returns a new state and never writes into the one it was given.

On a CUDA card the step's fixed-shape chains replay from CUDA graphs
(``core/graphs.py``): feature extraction, the searches and each
Gauss-Newton iteration's two halves (``solve/odometry.py``), and the tail
after the solve (:func:`_integrate`).  Their outputs are graph buffers that
the next scan overwrites (the next stream's, in ``batched_replay``), so the
state and ``AssociationOut`` a step returns are copies that share storage
with nothing else.
"""

from __future__ import annotations

import torch

from ..core import graphs, se3
from ..core.config import FeatureConfig, LegoLoamConfig
from ..core.device import DeviceLike, host_bool, resolve_device
from ..core.types import (AssociationOut, FeatureCloud, FeatureSet,
                          OdometryState, ProjectionOut)
from ..frontend.features import extract_features
from ..solve.odometry import deskew_to_end, two_step_odometry

Tensor = torch.Tensor


def _empty_cloud(n: int, device) -> FeatureCloud:
    return FeatureCloud(
        xyz=torch.zeros((n, 3), dtype=torch.float32, device=device),
        ring=torch.zeros((n,), dtype=torch.float32, device=device),
        rel_time=torch.zeros((n,), dtype=torch.float32, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device))


def init_state(cfg: LegoLoamConfig, device: DeviceLike = None
               ) -> OdometryState:
    device = resolve_device(device)
    f = cfg.feature
    return OdometryState(
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        transform_cur=torch.zeros((6,), dtype=torch.float32, device=device),
        odom=torch.zeros((6,), dtype=torch.float32, device=device),
        last_corner=_empty_cloud(f.max_less_sharp, device),
        last_surf=_empty_cloud(f.max_less_flat, device))


def _to_end(theta: Tensor, fc: FeatureCloud) -> FeatureCloud:
    """De-skew a feature cloud to the sweep-end frame
    (``publishCloudsLast``, ``featureAssociation.cpp:1329-1383``)."""
    xyz = deskew_to_end(theta, fc.xyz, fc.rel_time)
    return fc.replace(xyz=torch.where(fc.valid[:, None], xyz, 0.0))


def _integrate(theta_star: Tensor, transform_cur: Tensor, odom: Tensor,
               less_sharp: FeatureCloud, less_flat: FeatureCloud,
               f: FeatureConfig):
    """The step's tail after the solve: the physical trust region and the
    cross-frame under-relaxation (``FeatureConfig.odom_max_delta_*`` /
    ``odom_relax``), the integrated pose, and the clouds de-skewed to the
    sweep's end.  Returns (θ, odom, last_corner, last_surf)."""
    limit = graphs.constant([f.odom_max_delta_rot] * 3
                            + [f.odom_max_delta_trans] * 3,
                            torch.float32, theta_star.device)
    delta = torch.clamp(theta_star - transform_cur, -limit, limit)
    theta = se3.normalize_angles(transform_cur + f.odom_relax * delta)
    odom = se3.normalize_angles(se3.compose(odom, theta))
    return theta, odom, _to_end(theta, less_sharp), _to_end(theta, less_flat)


def odometry_step(state: OdometryState, proj: ProjectionOut,
                  cfg: LegoLoamConfig):
    """One scan through feature extraction + two-step GN odometry.

    Returns (new_state, AssociationOut) — the AssociationOut carries the
    integrated odometry pose and the end-frame feature clouds that feed
    mapping every ``mapping_frequency_divider`` scans (:1432-1448).
    """
    feats: FeatureSet = graphs.run(extract_features, proj.segmented, cfg)

    if not host_bool(state.initialized):
        # checkSystemInitialization (:1181-1209)
        theta, odom = state.transform_cur, state.odom
        corner, surf = feats.less_sharp, feats.less_flat
    else:
        theta_star = two_step_odometry(
            state.transform_cur, feats.sharp, feats.flat,
            state.last_corner, state.last_surf, cfg)
        theta, odom, corner, surf = graphs.run(
            _integrate, theta_star, state.transform_cur, state.odom,
            feats.less_sharp, feats.less_flat, cfg.feature)
    theta, odom, corner, surf = graphs.owned((theta, odom, corner, surf))
    new_state = OdometryState(
        initialized=torch.ones_like(state.initialized),
        transform_cur=theta, odom=odom, last_corner=corner, last_surf=surf)

    out = AssociationOut(
        corner_xyz=new_state.last_corner.xyz,
        corner_valid=new_state.last_corner.valid,
        surf_xyz=new_state.last_surf.xyz,
        surf_valid=new_state.last_surf.valid,
        outlier_xyz=proj.outlier_xyz,
        outlier_valid=proj.outlier_valid,
        odom=new_state.odom,
        scan2d_xyz=proj.scan2d_xyz,
        scan2d_valid=proj.scan2d_valid,
        stamp=proj.stamp)
    return new_state, out

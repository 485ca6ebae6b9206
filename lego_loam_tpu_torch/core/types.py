"""Payload containers flowing between pipeline stages.

Plain ``@dataclass`` containers of tensors with the field names and shapes
of the JAX package's state pytrees, so a state can be carried
across leaf by leaf through NumPy (``convert.py``).  Dynamic point clouds
are fixed-capacity tensors + validity masks/counts.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


class Container:
    """Mixin: functional field update (``obj.replace(field=value)``)."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RawScan(Container):
    """One unordered input sweep (the ``/lidar_points`` payload)."""

    xyz: Tensor        # (P, 3) float32; padding rows arbitrary
    valid: Tensor      # (P,)  bool
    stamp: Tensor      # ()    float32 seconds


@dataclasses.dataclass
class RangeImage(Container):
    """Stage-1 output image set (V, H): the reference's ``_range_mat`` /
    ``_full_cloud`` (``imageProjection.cpp:178-224``)."""

    rng: Tensor        # (V, H) float32, +inf where empty
    xyz: Tensor        # (V, H, 3) float32
    valid: Tensor      # (V, H) bool
    ground: Tensor     # (V, H) bool
    label: Tensor      # (V, H) int32 segment label; -1 invalid/unsegmented
    start_orientation: Tensor  # () float32
    end_orientation: Tensor    # () float32


@dataclasses.dataclass
class SegmentedCloud(Container):
    """Per-ring compacted segmented cloud — the reference's flattened
    ``segmented_cloud`` + ``cloud_info`` metadata (``imageProjection.cpp:
    352-409``).  Shape (V, S): ring-major, compacted left, masked right."""

    xyz: Tensor        # (V, S, 3)
    rng: Tensor        # (V, S) range
    col: Tensor        # (V, S) int32 original column index
    is_ground: Tensor  # (V, S) bool
    valid: Tensor      # (V, S) bool
    count: Tensor      # (V,) int32 valid points per ring
    rel_time: Tensor   # (V, S) float32 intra-scan relative time in [0,1)


@dataclasses.dataclass
class ProjectionOut(Container):
    """Channel payload IP → FA (``utility.h:64-70``)."""

    segmented: SegmentedCloud
    outlier_xyz: Tensor      # (O, 3)
    outlier_valid: Tensor    # (O,)
    scan2d_xyz: Tensor       # (H, 3) virtual 2D scan points (chest height)
    scan2d_valid: Tensor     # (H,)
    stamp: Tensor


@dataclasses.dataclass
class FeatureCloud(Container):
    """A masked fixed-capacity feature point set."""

    xyz: Tensor        # (N, 3)
    ring: Tensor       # (N,) float32 (fractional rings allowed after deskew)
    rel_time: Tensor   # (N,)
    valid: Tensor      # (N,) bool

    @property
    def count(self) -> Tensor:
        return torch.sum(self.valid.to(torch.int32))


@dataclasses.dataclass
class FeatureSet(Container):
    """Stage-2 feature extraction output (``featureAssociation.cpp:265-383``)."""

    sharp: FeatureCloud        # cornerPointsSharp     (label 2)
    less_sharp: FeatureCloud   # cornerPointsLessSharp (label 1)
    flat: FeatureCloud         # surfPointsFlat        (label -1)
    less_flat: FeatureCloud    # surfPointsLessFlat    (voxel-downsampled)


@dataclasses.dataclass
class AssociationOut(Container):
    """Channel payload FA → MO (``utility.h:73-80``): the last less-sharp /
    less-flat clouds de-skewed to scan end + integrated odometry."""

    corner_xyz: Tensor       # (C, 3)
    corner_valid: Tensor     # (C,)
    surf_xyz: Tensor         # (S, 3)
    surf_valid: Tensor       # (S,)
    outlier_xyz: Tensor      # (O, 3)
    outlier_valid: Tensor    # (O,)
    odom: Tensor             # (6,) pose in odom frame
    scan2d_xyz: Tensor       # (H, 3)
    scan2d_valid: Tensor     # (H,)
    stamp: Tensor


@dataclasses.dataclass
class OdometryState(Container):
    """Rolling state of the scan-to-scan odometry (stage 2)."""

    initialized: Tensor      # () bool
    transform_cur: Tensor    # (6,) last inter-scan motion (warm start)
    odom: Tensor             # (6,) integrated odometry pose
    last_corner: FeatureCloud
    last_surf: FeatureCloud

"""YAML/dict config loading — reference parameter-name compatibility.

The port's own copy of the JAX package's ``core/params.py`` (a test holds the
two equal).  ``yaml`` is imported only inside :func:`config_from_yaml`.

The reference loads a flat YAML into the rosparam server
(``launch/run.launch:20``, ``config/loam_config.yaml``) with namespaces
``lego_loam/{laser,imageProjection,featureAssociation,mapping}``.  This
module maps those exact names onto :class:`LegoLoamConfig`, so a user of
the reference can bring their tuned YAML unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .config import LegoLoamConfig

# reference-yaml key → (section, field) in LegoLoamConfig
_KEYMAP = {
    ("laser", "num_vertical_scans"): ("laser", "num_vertical_scans"),
    ("laser", "num_horizontal_scans"): ("laser", "num_horizontal_scans"),
    ("laser", "ground_scan_index"): ("laser", "ground_scan_index"),
    ("laser", "vertical_angle_bottom"): ("laser",
                                         "vertical_angle_bottom_deg"),
    ("laser", "vertical_angle_top"): ("laser", "vertical_angle_top_deg"),
    ("laser", "sensor_mount_angle"): ("laser", "sensor_mount_angle_deg"),
    ("laser", "scan_period"): ("laser", "scan_period"),
    ("imageProjection", "segment_valid_point_num"):
        ("projection", "segment_valid_point_num"),
    ("imageProjection", "segment_valid_line_num"):
        ("projection", "segment_valid_line_num"),
    ("imageProjection", "segment_theta"):
        ("projection", "segment_theta_deg"),
    ("featureAssociation", "edge_threshold"):
        ("feature", "edge_threshold"),
    ("featureAssociation", "surf_threshold"):
        ("feature", "surf_threshold"),
    ("featureAssociation", "nearest_feature_search_distance"):
        ("feature", "nearest_feature_search_dist"),
    ("mapping", "mapping_frequency_divider"):
        ("mapping", "mapping_frequency_divider"),
    ("mapping", "enable_loop_closure"):
        ("mapping", "enable_loop_closure"),
    ("mapping", "surrounding_keyframe_search_radius"):
        ("mapping", "surrounding_keyframe_search_radius"),
    ("mapping", "surrounding_keyframe_search_num"):
        ("mapping", "surrounding_keyframe_search_num"),
    ("mapping", "history_keyframe_search_radius"):
        ("mapping", "history_keyframe_search_radius"),
    ("mapping", "history_keyframe_search_num"):
        ("mapping", "history_keyframe_search_num"),
    ("mapping", "history_keyframe_fitness_score"):
        ("mapping", "history_keyframe_fitness_score"),
    ("mapping", "global_map_visualization_search_radius"):
        ("mapping", "global_map_visualization_search_radius"),
}


def config_from_dict(params: Dict[str, Any],
                     base: Optional[LegoLoamConfig] = None
                     ) -> LegoLoamConfig:
    """Build a config from a reference-style nested dict
    (``{"lego_loam": {"laser": {...}, ...}}`` or the inner dict directly).
    Unknown keys raise — silent typos in tuning files are how trajectories
    go quietly wrong."""
    base = base or LegoLoamConfig()
    if "lego_loam" in params:
        params = params["lego_loam"]

    updates: Dict[str, Dict[str, Any]] = {}
    for ns, sub in params.items():
        if not isinstance(sub, dict):
            raise KeyError(f"unexpected top-level scalar {ns!r}")
        for key, value in sub.items():
            if (ns, key) not in _KEYMAP:
                raise KeyError(f"unknown parameter {ns}/{key}")
            section, field = _KEYMAP[(ns, key)]
            updates.setdefault(section, {})[field] = value

    kwargs = {}
    for section in ("laser", "projection", "feature", "mapping",
                    "grid2d", "pipeline"):
        cur = getattr(base, section)
        if section in updates:
            kwargs[section] = dataclasses.replace(cur, **updates[section])
        else:
            kwargs[section] = cur
    return LegoLoamConfig(**kwargs)


def config_from_yaml(path: str,
                     base: Optional[LegoLoamConfig] = None
                     ) -> LegoLoamConfig:
    import yaml

    with open(path) as f:
        return config_from_dict(yaml.safe_load(f), base)

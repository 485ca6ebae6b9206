"""Shared helpers of the ``test_torch_*`` files: the small configuration on
both sides, NumPy bridges between the JAX package and the PyTorch port."""

import dataclasses

import jax
import numpy as np
import torch

from lego_loam_tpu.core import config as jcfg
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.core import config as tcfg

# The suite runs several worker processes on few cores, and these shapes are
# too small to gain from intra-op threads: one thread per worker keeps the
# port's tests from crowding the long JAX tests that run beside them.
torch.set_num_threads(1)

_SMALL = dict(
    laser=dict(num_horizontal_scans=360),
    feature=dict(max_sharp=64, max_less_sharp=512, max_flat=128,
                 max_less_flat=2048, odom_surf_iters=5, odom_corner_iters=5),
    mapping=dict(enable_loop_closure=False, max_map_corner=4096,
                 max_map_surf=8192, max_keyframes=128, scan2map_iters=3,
                 surrounding_keyframe_search_num=8, loop_history_cap=8192,
                 loop_source_cap=1024, icp_max_iters=16,
                 max_loop_factors=64),
    pipeline=dict(max_points=8192, max_segmented=4096, max_outlier=1024),
)


def _build(mod, overrides):
    merged = {k: dict(v) for k, v in _SMALL.items()}
    for section, kw in overrides.items():
        merged.setdefault(section, {}).update(kw)
    return mod.LegoLoamConfig(
        laser=mod.LaserConfig(**merged["laser"]),
        feature=mod.FeatureConfig(**merged["feature"]),
        mapping=mod.MappingConfig(**merged["mapping"]),
        pipeline=mod.PipelineConfig(**merged["pipeline"]))


def small_cfgs(**overrides):
    """(JAX-package config, port config): the shape-reduced configuration of
    ``__graft_entry__._small_cfg`` with loop closure off, built from one
    dict so the two cannot differ.  ``overrides``: section → field dict."""
    j, t = _build(jcfg, overrides), _build(tcfg, overrides)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def port_cfg(jax_cfg):
    """The port's config with every field of the JAX package's."""
    return tcfg.LegoLoamConfig(**{
        f.name: type(getattr(tcfg.LegoLoamConfig(), f.name))(
            **dataclasses.asdict(getattr(jax_cfg, f.name)))
        for f in dataclasses.fields(jax_cfg)})


def to_np(tree):
    """JAX pytree → same structure with NumPy leaves."""
    return jax.tree.map(np.asarray, tree)


def to_torch(kind, jax_tree):
    """JAX container → the port's container on the CPU."""
    return convert.from_numpy_tree(kind, to_np(jax_tree), device="cpu")


def tnp(x):
    return x.detach().cpu().numpy()

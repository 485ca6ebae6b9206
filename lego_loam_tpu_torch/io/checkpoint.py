"""Checkpoint / resume — state snapshots in the JAX package's file format.

The reference keeps all state in RAM with no save/load; the JAX package
checkpoints its whole ``SlamState`` pytree (keyframe store, factor graph,
odometry state, submap grid) to one ``.npz`` and restores it bit-exactly.
This module writes and reads the SAME format for the port's containers: one
array ``leaf_<i>`` per leaf in field order, and ``keys``, the leaves' paths
as the JAX package names them (``.mapping/.meta/.kf_pose``).  So a
checkpoint written by either package loads into the other
(``SlamState.scan_index``, a host int here, is stored as an int32 array as
there).

A JAX-package checkpoint stores ``keys`` as a pickled object array, so
:func:`load_state` unpickles: load only checkpoints you wrote.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from .. import convert


def _leaves(obj: Any, path: Tuple[str, ...] = ()) -> List[tuple]:
    """(key, leaf) pairs of a port container in field order; a leaf is a
    tensor or the host int ``scan_index``."""
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out += _leaves(getattr(obj, f.name), path + ("." + f.name,))
        return out
    return [("/".join(path), obj)]


def _spec(leaf) -> tuple:
    """(shape, NumPy dtype) a leaf is stored with."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(str(leaf.dtype).split(".")[-1])
    return (), np.dtype(np.int32)


def save_state(path: str, state: Any) -> None:
    """Write a port state container (e.g. ``SlamState``) to ``path``.
    Keyframe blocks row-sharded over a mesh are written whole
    (``convert.to_numpy_tree`` assembles them), so the file is the JAX
    package's either way."""
    flat = _leaves(state)
    data = {f"leaf_{i}": convert.to_numpy_tree(v)
            for i, (_, v) in enumerate(flat)}
    data["keys"] = np.asarray([k for k, _ in flat])
    np.savez_compressed(path, **data)


def load_state(path: str, template: Any) -> Any:
    """Restore a checkpoint into the structure of ``template`` (a port state
    container with the same layout, e.g. ``slam.init_state(cfg, device)``),
    on the template's device.  Raises ``ValueError`` on a layout, shape or
    dtype mismatch."""
    flat_t = _leaves(template)
    keys_t = [k for k, _ in flat_t]
    with np.load(path, allow_pickle=True) as z:
        keys_s = [str(k) for k in z["keys"]]
        if keys_s != keys_t:
            raise ValueError(
                "checkpoint layout mismatch: "
                f"saved {len(keys_s)} leaves, template {len(keys_t)}")
        tree: dict = {}
        for i, (key, leaf) in enumerate(flat_t):
            arr = z[f"leaf_{i}"]
            shape, dtype = _spec(leaf)
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"leaf {key}: saved {arr.shape}/{arr.dtype} != "
                    f"template {shape}/{dtype}")
            node = tree
            parts = [p[1:] for p in key.split("/")]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    device = next(v.device for _, v in flat_t if isinstance(v, torch.Tensor))
    return convert.from_numpy_tree(type(template).__name__, tree,
                                   device=device)

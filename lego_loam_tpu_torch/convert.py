"""Carry pipeline state between the JAX package and this port via NumPy.

This system has no weights; what both sides must agree on is the STATE in
the middle of the pipeline.  :func:`from_numpy_tree` turns a container of
the JAX package — handed over as a nested dict or dataclass whose leaves
are **NumPy arrays** — into the port's container of the same name;
:func:`to_numpy_tree` goes back to a nested dict of NumPy arrays with the
same field names.  The caller does the ``jax → numpy`` step
(``jax.tree.map(np.asarray, …)``); nothing here knows about JAX.

One field differs by design: ``SlamState.scan_index`` is a host ``int`` in
the port.

:func:`split_batched` takes a BATCHED container of the JAX package (what its
``batched_replay`` returns: a leading B axis on every leaf) and gives B of the
port's containers, the port's ``batched_replay`` returning a list of states.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from .core import types as T
from .core.device import DeviceLike, resolve_device
from .graph import keyframes as K
from .graph import posegraph as G
from .graph import submap_grid as SG
from .pipeline import mapping as M
from .pipeline import slam as S

KINDS = {
    "RawScan": T.RawScan,
    "RangeImage": T.RangeImage,
    "SegmentedCloud": T.SegmentedCloud,
    "ProjectionOut": T.ProjectionOut,
    "FeatureCloud": T.FeatureCloud,
    "FeatureSet": T.FeatureSet,
    "AssociationOut": T.AssociationOut,
    "OdometryState": T.OdometryState,
    "KeyframeClouds": K.KeyframeClouds,
    "KeyframeRow": K.KeyframeRow,
    "FactorGraph": G.FactorGraph,
    "SubmapGrid": SG.SubmapGrid,
    "MappingMeta": M.MappingMeta,
    "MappingState": M.MappingState,
    "SlamState": S.SlamState,
}

# fields that hold another container, by (kind, field)
_NESTED = {
    ("ProjectionOut", "segmented"): "SegmentedCloud",
    ("FeatureSet", "sharp"): "FeatureCloud",
    ("FeatureSet", "less_sharp"): "FeatureCloud",
    ("FeatureSet", "flat"): "FeatureCloud",
    ("FeatureSet", "less_flat"): "FeatureCloud",
    ("OdometryState", "last_corner"): "FeatureCloud",
    ("OdometryState", "last_surf"): "FeatureCloud",
    ("MappingMeta", "graph"): "FactorGraph",
    ("MappingMeta", "grid"): "SubmapGrid",
    ("MappingState", "meta"): "MappingMeta",
    ("MappingState", "clouds"): "KeyframeClouds",
    ("SlamState", "odo"): "OdometryState",
    ("SlamState", "mapping"): "MappingState",
}


def _field(tree: Any, name: str):
    if isinstance(tree, dict):
        return tree[name]
    return getattr(tree, name)


def _leaf(x, device: torch.device, index: Optional[int] = None
          ) -> torch.Tensor:
    a = np.array(x if index is None else np.asarray(x)[index],
                 copy=True)             # own, writable, contiguous
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def from_numpy_tree(kind: str, tree: Any, device: DeviceLike = None,
                    index: Optional[int] = None):
    """Nested dict / dataclass of NumPy arrays → the port's ``kind``
    container with tensors on ``device`` (``None`` = the CUDA card).
    ``index``: take entry ``index`` of the leading axis of every leaf (one
    stream of a batched container)."""
    device = resolve_device(device)
    cls = KINDS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        if (kind, f.name) == ("SlamState", "scan_index"):
            x = np.asarray(_field(tree, f.name))
            kw[f.name] = int(x if index is None else x[index])
        elif (kind, f.name) in _NESTED:
            kw[f.name] = from_numpy_tree(_NESTED[(kind, f.name)],
                                         _field(tree, f.name), device, index)
        else:
            kw[f.name] = _leaf(_field(tree, f.name), device, index)
    return cls(**kw)


def split_batched(kind: str, tree: Any, device: DeviceLike = None) -> List:
    """A batched JAX container (leading B axis on every leaf, as NumPy
    arrays) → a list of B of the port's ``kind`` containers."""
    first = tree
    while dataclasses.is_dataclass(first) or isinstance(first, dict):
        first = next(iter(first.values())) if isinstance(first, dict) \
            else getattr(first, dataclasses.fields(first)[0].name)
    return [from_numpy_tree(kind, tree, device, index=b)
            for b in range(np.asarray(first).shape[0])]


def to_numpy_tree(obj: Any):
    """The port's container → nested dict of NumPy arrays (same names)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, int):
        return np.asarray(obj, np.int32)
    return obj

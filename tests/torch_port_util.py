"""Shared helpers of the ``test_torch_*`` files: the small configuration on
both sides, NumPy bridges between the JAX package and the PyTorch port, and
the port's CPU replay of the JAX package's loop-lap sequences."""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import config as jcfg
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.core import config as tcfg
from lego_loam_tpu_torch.core import graphs
from lego_loam_tpu_torch.core import se3 as tse3
from lego_loam_tpu_torch.eval.metrics import ate

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


def gt_relative(gt):
    """Ground truth poses (N, 6) relative to the first, as NumPy."""
    g = torch.from_numpy(np.asarray(gt, np.float32))
    return tnp(tse3.relative(g[0], g))


def ate_vs_truth(fused, gt):
    """ATE as the benchmark harness and the JAX package's tests take it:
    estimate k against relative truth k+1, no alignment."""
    return ate(fused[:-1], gt_relative(gt)[1:len(fused)], align=False)


# The loop laps of the JAX package's tests, on ``small_loop_cfg``: scans,
# then ``make_sequence``'s keywords.  seed 33 is ``test_loop_e2e._loop_run``
# (~1.33 laps), seed 55 ``test_parity_loop_on_second_seed`` (1.5 laps).
LAPS = {"seed33-r2.2": (110, dict(seed=33, radius=2.2, speed=1.6)),
        "seed55-r1.7": (80, dict(seed=55, radius=1.7, speed=2.0))}


@functools.lru_cache(maxsize=2)
def _sequence(n, seq):
    """``make_sequence(n, small_loop_cfg(), noise=0.01, **dict(seq))``: the
    scans, times and ground truth, and the scans packed for the port."""
    from lego_loam_tpu.io.synthetic import make_sequence
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from tests.test_loop_e2e import small_loop_cfg

    jc = small_loop_cfg()
    scans, gt, times = make_sequence(n, jc, noise=0.01, **dict(seq))
    packed = pack_sequence(scans, times, port_cfg(jc), device="cpu")
    return (scans, gt, times), packed


def lap_sequence(n, seq):
    """(scans, ground truth, times) of ``make_sequence(n, small_loop_cfg(),
    noise=0.01, **seq)``."""
    return _sequence(n, tuple(sorted(seq.items())))[0]


def replay_drive(n, seq, **mapping):
    """(final state, outputs with NumPy leaves, ground truth) of the port's
    CPU replay of ``make_sequence(n, small_loop_cfg(), noise=0.01, **seq)``;
    ``mapping`` overrides MappingConfig fields.  These replays are the port's
    longest tests, so they take two intra-op threads (one thread put the
    seed-33 lap over a minute); the worker's setting is restored after."""
    from lego_loam_tpu_torch.pipeline.slam import replay
    from tests.test_loop_e2e import small_loop_cfg

    cfg = port_cfg(small_loop_cfg())
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, **mapping))
    (_, gt, _), (xyz, valid, t) = _sequence(n, tuple(sorted(seq.items())))
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        final, outs = replay(xyz, valid, t, cfg, device="cpu")
    finally:
        torch.set_num_threads(before)
    return final, {k: v.numpy() for k, v in outs.items()}, gt


# ---------------------------------------------------------------------------
# ``core/graphs.py``'s graph path, emulated on the CPU
# ---------------------------------------------------------------------------

def leaves(tree):
    """The tensors of a tree as ``core/graphs.py`` walks it."""
    out = []
    graphs._flatten(tree, out)
    return out


def storages(tree):
    """The storages of a tree's non-empty tensors."""
    return {t.untyped_storage().data_ptr() for t in leaves(tree)
            if t.numel()}


@dataclasses.dataclass
class EmulatedGraphs:
    entries: dict        # the runner's entries of this thread
    depth: list          # [n]: n > 0 while a chain is being run

    @property
    def in_chain(self) -> bool:
        return self.depth[0] > 0

    def buffers(self):
        """The storages of every entry's static inputs and outputs."""
        out = set()
        for entry in self.entries.values():
            out |= storages(entry.inputs) | storages(entry.outputs)
        return out


@contextlib.contextmanager
def graphs_replayed_on_cpu():
    """``core/graphs.py``'s graph path on the CPU: a chain is 'captured'
    once per key, and each 'replay' writes into the buffers of the first
    call's outputs, as a CUDA graph's replay writes into its pool (an output
    that is an input stays the static input, rewritten by the next copy)."""
    depth = [0]

    def record(fn, spec, static):
        def call():
            depth[0] += 1
            try:
                return fn(*graphs._unflatten(spec, iter(static)))
            finally:
                depth[0] -= 1
        outputs = call()

        def replay():
            for dst, src in zip(leaves(outputs), leaves(call())):
                dst.copy_(src)
        return replay, outputs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "_record", record)
        mp.setattr(graphs, "_replayable", lambda t: True)
        mp.setattr(graphs._LOCAL, "entries", {}, raising=False)
        yield EmulatedGraphs(graphs._entries(), depth)

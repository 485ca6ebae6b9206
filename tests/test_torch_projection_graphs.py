"""Stage 1 (``frontend/segmentation.py::image_projection``) as two chains
replayed from CUDA graphs (``core/graphs.py``) around an eager K1 launch,
held on the CPU to the bits of stage 1 before it was split.

Five scans of a small configuration; ``tests/data/projection_scans.npz``
holds what :func:`projections` gave on the code before the split (``python
tests/test_torch_projection_graphs.py`` writes it anew): every field of
each scan's ``ProjectionOut``, read after the last scan."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch.core import graphs
from lego_loam_tpu_torch.frontend import segmentation
from lego_loam_tpu_torch.io import npz_io, synthetic
from torch_port_util import graphs_replayed_on_cpu, small_cfgs, storages

_, CFG = small_cfgs()
SCANS = 5
STREAMS = 3       # stream b takes scan (i + b) mod SCANS at lock-step i
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "projection_scans.npz")


def _raws(cfg, n):
    scans, _, times = synthetic.make_sequence(n, cfg, seed=11, noise=0.01,
                                              speed=1.2)
    return [npz_io.pack_raw_scan(p, float(t), cfg.pipeline.max_points, "cpu")
            for p, t in zip(scans, times)]


def _named(tree, prefix, out):
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    else:
        for f in dataclasses.fields(tree):
            _named(getattr(tree, f.name), f"{prefix}.{f.name}", out)


def _arrays(outs):
    """{field_k: array} of the ``ProjectionOut``s ``outs``, scan k's."""
    arrays = {}
    for k, out in enumerate(outs):
        named = {}
        _named(out, "proj", named)
        arrays.update({f"{name}_{k}": t.numpy().copy()
                       for name, t in named.items()})
    return arrays


def projections(raws, cfg=CFG, watch=None):
    """``image_projection`` of each scan in turn, every result kept and read
    after the last scan.  ``watch(raw, result)`` sees each scan."""
    outs = []
    for raw in raws:
        out = segmentation.image_projection(raw, cfg)
        if watch is not None:
            watch(raw, out)
        outs.append(out)
    return _arrays(outs)


def lock_steps(raws, cfg=CFG):
    """``image_projection_batched`` over ``STREAMS`` streams, each step's
    results kept; per stream the arrays of its scans' results, named by the
    scan each result is of."""
    kept = [[] for _ in range(STREAMS)]
    for i in range(SCANS):
        batch = [raws[(i + b) % SCANS] for b in range(STREAMS)]
        for b, out in enumerate(
                segmentation.image_projection_batched(batch, cfg)):
            kept[b].append(((i + b) % SCANS, out))
    streams = []
    for results in kept:
        by_scan = dict(results)
        streams.append(_arrays([by_scan[k] for k in range(SCANS)]))
    return streams


def _assert_bits(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class _LabelCounter:
    """Counts the calls of ``segmentation.propagate_labels`` (the module
    attribute the stage check wraps) and those made while a chain runs."""

    def __init__(self, mp, emulated=None):
        self.calls = 0
        self.in_chain = 0
        label = segmentation.propagate_labels

        def propagate_labels(*args, **kwargs):
            self.calls += 1
            if emulated is not None and emulated.in_chain:
                self.in_chain += 1
            return label(*args, **kwargs)
        mp.setattr(segmentation, "propagate_labels", propagate_labels)


@pytest.fixture(scope="module")
def raws():
    return _raws(CFG, SCANS)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as ref:
        return {k: ref[k] for k in ref.files}


@pytest.fixture(scope="module")
def replayed(raws):
    """Stage 1 through the graph path emulated on the CPU: the scans one by
    one, then lock-step over three streams; with K1's calls counted, what
    each scan's result shares storage with, and the runner's entries."""
    with graphs_replayed_on_cpu() as emulated, \
            pytest.MonkeyPatch.context() as mp:
        shared = []

        def watch(raw, result):
            mine = storages(result)
            shared.append((mine & storages(raw), mine & emulated.buffers()))

        k1 = _LabelCounter(mp, emulated)
        got = projections(raws, watch=watch)
        single = (k1.calls, k1.in_chain)
        keys = set(emulated.entries)
        streams = lock_steps(raws)
        batched = (k1.calls - single[0], k1.in_chain - single[1])
        keys_after = set(emulated.entries)
    return dict(got=got, single=single, batched=batched, shared=shared,
                keys=keys, keys_after=keys_after, streams=streams)


def test_direct_calls_reproduce_the_golden_bits(raws, golden):
    """Stage 1 split into chains computes, called directly (as every CPU
    tensor is), what the unsplit stage computed, bit for bit."""
    _assert_bits(projections(raws), golden)
    assert len(golden) == SCANS * 12
    assert all(int(golden[f"proj.segmented.count_{k}"].sum()) > 0
               and golden[f"proj.outlier_valid_{k}"].any()
               and golden[f"proj.scan2d_valid_{k}"].any()
               for k in range(SCANS))


def test_replayed_scans_keep_the_bits(replayed, golden):
    _assert_bits(replayed["got"], golden)


def test_kept_results_share_no_storage(replayed):
    """No scan's result shares storage with its input scan or with any
    graph's buffers, and later scans (replaying the same graphs) leave it
    as it was: read after the last scan, it is the golden bits (the test
    above)."""
    assert len(replayed["shared"]) == SCANS
    for with_raw, with_buffers in replayed["shared"]:
        assert not with_raw and not with_buffers


def test_each_chain_is_captured_once(replayed):
    """Stage 1 has two chains, one entry each whatever the scan; the
    lock-step adds one entry for each of its two chains, whose key holds
    the number of streams."""
    single = sorted(key[0].__name__ for key in replayed["keys"])
    assert single == ["_project_and_edges", "_segment_labelled"]
    added = replayed["keys_after"] - replayed["keys"]
    assert sorted(key[0].__name__ for key in added) == [
        "_project_and_edges_batched", "_segment_labelled_batched"]


def test_k1_stays_eager(replayed):
    """K1 runs outside every chain and through the module attribute, so a
    wrapper on it sees one call a scan, and one a lock-step for all the
    streams."""
    assert replayed["single"] == (SCANS, 0)
    assert replayed["batched"] == (SCANS, 0)


def test_batched_equals_single_on_the_graph_path(replayed, golden):
    """Each stream's lock-step results are its scans' ``image_projection``
    results bit for bit, though one replay serves all the streams, and a
    later lock-step leaves them as they were."""
    for stream in replayed["streams"]:
        _assert_bits(stream, golden)


def test_cpu_tensors_never_capture(raws):
    """On the CPU the chains are called directly: no capture, no replay and
    no entry, for one scan or a lock-step."""
    before = (graphs.capture_count(), graphs.replay_count(),
              len(graphs._entries()))
    segmentation.image_projection(raws[0], CFG)
    segmentation.image_projection_batched(raws[:2], CFG)
    assert (graphs.capture_count(), graphs.replay_count(),
            len(graphs._entries())) == before


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **projections(_raws(CFG, SCANS)))

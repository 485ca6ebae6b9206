"""The mapping cycle (``pipeline/mapping.py::mapping_step``) as chains
replayed from CUDA graphs (``core/graphs.py``), held on the CPU to the bits
of the cycle before it was split.

Four mapping cycles of a small loop-closure-ON configuration from a fresh
state (20 scans, a cycle every fifth): the first on an empty map, which the
thin-map gate keeps from scan-to-map; a keyframe insert in each; scan-to-map
with fresh and stale iterations (``scan2map_iters`` 3, a re-association
every second); in the fourth a loop attempt that finds no candidate.
``tests/data/mapping_cycles.npz`` holds what :func:`cycles` gave on the code
before the split (``python tests/test_torch_mapping_graphs.py`` writes it
anew): every field of each cycle's results and its count of host reads."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch.core import device as tdevice
from lego_loam_tpu_torch.io import npz_io, synthetic
from lego_loam_tpu_torch.match import cuda_knn
from lego_loam_tpu_torch.pipeline import mapping, slam
from lego_loam_tpu_torch.solve import scan2map
from torch_port_util import graphs_replayed_on_cpu, small_cfgs, storages

_, CFG = small_cfgs(mapping=dict(enable_loop_closure=True))
SCANS = 20
LAG = 5           # the second of two streams runs one cycle behind the first
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "mapping_cycles.npz")


def _chains():
    """The loop-ON cycle's chains: each is captured once for a
    configuration."""
    return {mapping._prologue_grid, scan2map._to_map,
            scan2map._first_iteration, scan2map._update,
            scan2map._fresh_iteration, scan2map._stale_iteration,
            mapping._tail}


def _raws(cfg, n):
    scans, _, times = synthetic.make_sequence(n, cfg, seed=7, noise=0.01,
                                              speed=1.2)
    return [npz_io.pack_raw_scan(p, float(t), cfg.pipeline.max_points, "cpu")
            for p, t in zip(scans, times)]


def _named(tree, prefix, out):
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    else:
        for f in dataclasses.fields(tree):
            _named(getattr(tree, f.name), f"{prefix}.{f.name}", out)


def cycles(raws, cfg=CFG, lags=(0,), watch=None):
    """The mapping cycles of ``slam_step`` over ``raws`` from a fresh state,
    for one stream a lag: stream s steps scan i - lags[s] at step i, all
    streams on this thread in turn (``batched_replay``'s pattern).  Per
    stream, {name: array} of every cycle's results and host reads, read
    after the last step.  ``watch((meta, clouds, assoc), result)`` sees each
    cycle."""
    states = [slam.init_state(cfg, "cpu") for _ in lags]
    kept = [[] for _ in lags]
    current = [0]
    step = mapping.mapping_step

    def recorded(meta, clouds, assoc, cfg):
        before = tdevice.sync_count()
        result = step(meta, clouds, assoc, cfg)
        kept[current[0]].append((result, tdevice.sync_count() - before))
        if watch is not None:
            watch((meta, clouds, assoc), result)
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mapping, "mapping_step", recorded)
        for i in range(len(raws) + max(lags)):
            for s, lag in enumerate(lags):
                if 0 <= i - lag < len(raws):
                    current[0] = s
                    states[s], _ = slam.slam_step(states[s], raws[i - lag],
                                                  cfg, device="cpu")
    out = []
    for results in kept:
        arrays = {}
        for k, ((meta, row, pose, diag), reads) in enumerate(results):
            named = {"pose": pose, "loop_diag": diag}
            _named(meta, "meta", named)
            _named(row, "row", named)
            arrays.update({f"{name}_{k}": t.numpy().copy()
                           for name, t in named.items()})
            arrays[f"reads_{k}"] = np.asarray(reads)
        out.append(arrays)
    return out


def _assert_bits(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class _KnnCounter:
    """Counts the problems K2 is handed through its module attributes (the
    card's ``knn5_cuda_grouped``, the CPU's ``knn5_torch``: the stage check
    wraps both) and those handed it while a chain runs."""

    def __init__(self, mp, emulated=None):
        self.problems = 0
        self.in_chain = 0
        grouped, plain = cuda_knn.knn5_cuda_grouped, cuda_knn.knn5_torch

        def seen(n):
            self.problems += n
            if emulated is not None and emulated.in_chain:
                self.in_chain += n

        def knn5_cuda_grouped(problems):
            seen(len(problems))
            return grouped(problems)

        def knn5_torch(*problem):
            seen(1)
            return plain(*problem)
        mp.setattr(cuda_knn, "knn5_cuda_grouped", knn5_cuda_grouped)
        mp.setattr(cuda_knn, "knn5_torch", knn5_torch)


@pytest.fixture(scope="module")
def raws():
    return _raws(CFG, SCANS)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as ref:
        return {k: ref[k] for k in ref.files}


@pytest.fixture(scope="module")
def eager(raws):
    """The cycles called as they are on the CPU (every chain called
    directly), with K2's problems counted."""
    with pytest.MonkeyPatch.context() as mp:
        knn = _KnnCounter(mp)
        [got] = cycles(raws)
    return got, knn


@pytest.fixture(scope="module")
def replayed(raws):
    """The cycles through the graph path emulated on the CPU: one stream,
    then two interleaved; with K2's problems of the first counted, what each
    cycle's results share storage with, and the runner's entries after each
    run."""
    with graphs_replayed_on_cpu() as emulated, \
            pytest.MonkeyPatch.context() as mp:
        shared = []

        def watch(given, result):
            mine = storages(result)
            shared.append((mine & storages(given), mine & emulated.buffers()))

        knn = _KnnCounter(mp, emulated)
        [got] = cycles(raws, watch=watch)
        k2 = (knn.problems, knn.in_chain)
        keys = set(emulated.entries)
        streams = cycles(raws, lags=(0, LAG))
        keys_after = set(emulated.entries)
    return dict(got=got, k2=k2, k2_after=(knn.problems, knn.in_chain),
                shared=shared, keys=keys, keys_after=keys_after,
                streams=streams)


def test_mapping_cycles_reproduce_the_golden_bits(eager, golden):
    """The cycle split into chains computes, called directly, what the
    unsplit cycle computed, bit for bit, with the same host reads; and the
    cycles are what this file says they are."""
    got, _ = eager
    _assert_bits(got, golden)
    assert [int(golden[f"meta.kf_count_{k}"]) for k in range(4)] == [1, 2, 3, 4]
    # the first cycle reads only its thin-map gate and "attempt a closure";
    # a solved one reads its gate, each fresh iteration and the attempt flag
    assert int(golden["reads_0"]) == 2
    assert all(int(golden[f"reads_{k}"]) >= 3 for k in (1, 2))
    assert golden["loop_diag_3"][0] == 1.0 and golden["loop_diag_3"][1] == 0.0


def test_replayed_cycles_keep_the_bits(replayed, golden):
    _assert_bits(replayed["got"], golden)


def test_kept_results_share_no_storage(replayed):
    """No cycle's results share storage with the state and scan passed in or
    with any graph's buffers, and a later cycle (replaying the same graphs)
    leaves them as they were: read after the last scan, they are the golden
    bits (the test above)."""
    assert len(replayed["shared"]) == 4
    for with_given, with_buffers in replayed["shared"]:
        assert not with_given and not with_buffers


def test_interleaved_streams_leave_each_other_alone(replayed, golden):
    """Two streams on one thread, one a cycle behind, replay the same graphs
    in turn; each stream's cycles are its own run's."""
    first, second = replayed["streams"]
    _assert_bits(first, golden)
    _assert_bits(second, golden)


def test_each_chain_is_captured_once(replayed):
    """Each of the cycle's chains has one entry: its key grows neither with
    the iteration nor with the cycle, and two more streams capture
    nothing."""
    keys = replayed["keys"]
    chains = _chains()
    stage3 = [key[0] for key in keys if key[0] in chains]
    assert sorted(f.__name__ for f in stage3) == sorted(
        f.__name__ for f in chains)
    assert replayed["keys_after"] == keys


def test_k2_stays_eager(eager, replayed):
    """K2 runs outside every chain and through its module attributes, so a
    wrapper on them sees as many problems, two an association, as when
    nothing is replayed (twice as many for two streams)."""
    _, plain = eager
    problems, in_chain = replayed["k2"]
    assert problems == plain.problems > 0 and problems % 2 == 0
    assert replayed["k2_after"] == (3 * problems, 0) and in_chain == 0


def test_loop_off_cycles_replay_bit_equal():
    """With loop closure off (the radius submap, whose keyframe rows are
    gathered eagerly between two chains) the graph path gives the bits of
    the direct calls."""
    cfg = CFG.replace(mapping=dataclasses.replace(
        CFG.mapping, enable_loop_closure=False))
    raws = _raws(cfg, 10)
    [want] = cycles(raws, cfg)
    with graphs_replayed_on_cpu() as emulated:
        [got] = cycles(raws, cfg)
        chains = {key[0] for key in emulated.entries}
    _assert_bits(got, want)
    assert {mapping._prologue_radius, mapping._radius_submap} <= chains
    assert int(want["meta.kf_count_1"]) == 2 and int(want["reads_1"]) >= 2


if __name__ == "__main__":
    [cycle_bits] = cycles(_raws(CFG, SCANS))
    np.savez_compressed(GOLDEN, **cycle_bits)

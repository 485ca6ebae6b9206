"""PyTorch port vs JAX package: the mesh, the factor-sharded pose-graph solve
and sharded replay, on the CPU.

A port mesh is a tuple of shard devices; here every shard is the CPU (a
device may repeat).  The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``.  Tolerances are those of the JAX package's own
``tests/test_distributed.py``: the sharded partial sums differ from the
single-device ``index_add_`` order by rounding only, so the loop graph
agrees to 1e-4 and the stiff 420-node chain to 5 mm (absolute, on a 125 m
chain), with PCG iteration counts within 30 % + 8 of each other and both
far under the cap.  (The stiff chain is built and solved on the port's side
only: the JAX package's sharded solve is held to the port's on the loop
graph, and a second JAX compile would not fit this file's time.)  Sharded replay is exact against per-stream ``replay``
(each shard runs the same code on the same device type)."""

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from lego_loam_tpu.distributed.mesh import make_mesh as jmake_mesh
from lego_loam_tpu.distributed.sharded_pgo import \
    optimize_poses_sharded as joptimize_sharded
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.core import device as tdevice
from lego_loam_tpu_torch.core import se3 as tse3
from lego_loam_tpu_torch.core.config import vlp16
from lego_loam_tpu_torch.distributed import mesh as tmesh
from lego_loam_tpu_torch.distributed import sharded_pgo
from lego_loam_tpu_torch.graph import keyframes
from lego_loam_tpu_torch.graph.posegraph import (add_factor, empty_graph,
                                                 optimize_poses)
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.pipeline import mapping as tmapping
from lego_loam_tpu_torch.pipeline import slam as tslam
from tests.test_distributed import _loop_graph
from torch_port_util import small_cfgs, tnp, to_torch


def _port(jgraph):
    poses, n, g = jgraph
    return (torch.from_numpy(np.array(poses)),
            torch.tensor(int(n), dtype=torch.int32),
            to_torch("FactorGraph", g))


def _cpu_mesh(n):
    return tmesh.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def loop_graph():
    return _loop_graph()


@pytest.fixture(scope="module")
def loop_solutions(loop_graph):
    """(JAX on 8 devices, port single-device) solves."""
    assert len(jax.devices()) >= 8, "conftest must fan out 8 CPU devices"
    poses, n, g = loop_graph
    jsh = np.asarray(joptimize_sharded(poses, n, g, jmake_mesh(8, "pgo"),
                                       axis="pgo", gn_iters=8, pcg_iters=64))
    single = tnp(optimize_poses(*_port(loop_graph), gn_iters=8,
                                pcg_iters=64))
    return jsh, single


def test_sharded_pgo_matches_jax_and_single_device(loop_graph,
                                                   loop_solutions):
    jsh, single = loop_solutions
    runs = sharded_pgo.solve_count
    out = tnp(sharded_pgo.optimize_poses_sharded(
        *_port(loop_graph), _cpu_mesh(4), gn_iters=8,
        pcg_iters=64))
    assert sharded_pgo.solve_count == runs + 1
    np.testing.assert_allclose(out, single, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, jsh, rtol=1e-4, atol=1e-4)
    n = int(loop_graph[1])
    assert np.abs(out[:n] - tnp(_port(loop_graph)[0])[:n]).max() > 0.01


@pytest.mark.parametrize("shards", [3, 5, 7])
def test_sharded_pgo_pads_the_factor_axis(loop_graph, loop_solutions,
                                          shards):
    """256 factor slots do not divide over 3, 5 or 7 shards: the padded
    invalid factors add exact zeros."""
    poses, n, g = _port(loop_graph)
    assert g.i.shape[0] % shards != 0
    padded = sharded_pgo._pad_factors(g, shards)
    F = padded.i.shape[0]
    assert F % shards == 0 and F - g.i.shape[0] < shards
    assert not padded.valid[g.i.shape[0]:].any()
    assert (padded.weight[g.i.shape[0]:] == 0).all()
    out = tnp(sharded_pgo.optimize_poses_sharded(
        poses, n, g, _cpu_mesh(shards), gn_iters=8,
        pcg_iters=64))
    np.testing.assert_allclose(out, loop_solutions[1], rtol=1e-4, atol=1e-4)


def _stiff_chain(n=420, K=512):
    """``tests/test_distributed.py::_stiff_chain`` on the port's side: a
    420-node odometry chain at the SHIPPED odometry weight (``‖b‖²`` ~1e6)
    with a yaw drift, plus one soft loop factor closing it."""
    odom_w = torch.tensor(vlp16().mapping.odom_factor_weight)
    loop_w = torch.full((6,), 3.0)
    rng = np.random.default_rng(7)
    g = empty_graph(1024, "cpu")
    count = torch.zeros((), dtype=torch.int32)
    poses = torch.zeros((K, 6))
    step = np.asarray([0, 0, 0.004, 0.3, 0, 0], np.float32)
    for k in range(n - 1):
        z = torch.from_numpy(step + rng.normal(0, 1e-3, 6).astype(np.float32))
        poses[k + 1] = tse3.compose(poses[k], z)
        g, count = add_factor(g, count, torch.tensor(k), torch.tensor(k + 1),
                              z, odom_w)
    gt_end = torch.tensor([0, 0, 0, 0.3 * (n - 1), 0, 0])
    z_loop = tse3.relative(gt_end, torch.zeros(6))
    g, count = add_factor(g, count, torch.tensor(n - 1), torch.tensor(0),
                          z_loop, loop_w)
    return poses, torch.tensor(n, dtype=torch.int32), g


def test_sharded_pcg_early_exit_stiff_chain():
    """The live mapping settings (gn_iters=3, pcg_iters=64) on the stiff
    chain: the sharded solve agrees with the single-device one, both exit
    early on every GN step with near-identical counts, and the end moves
    toward the truth."""
    poses, n, g = _stiff_chain()
    single, single_it = optimize_poses(poses, n, g, gn_iters=3, pcg_iters=64,
                                       return_iters=True)
    out, out_it = sharded_pgo.optimize_poses_sharded(
        poses, n, g, _cpu_mesh(4), gn_iters=3, pcg_iters=64,
        return_iters=True)
    out = tnp(out)
    np.testing.assert_allclose(out, tnp(single), rtol=1e-3, atol=5e-3)
    assert max(out_it) < 32 and max(single_it) < 32, (out_it, single_it)
    assert abs(sum(out_it) - sum(single_it)) <= 0.3 * sum(single_it) + 8, \
        (out_it, single_it)
    gt_end = np.asarray([0.3 * (int(n) - 1), 0, 0])
    err_before = np.linalg.norm(tnp(poses)[int(n) - 1, 3:] - gt_end)
    err_after = np.linalg.norm(out[int(n) - 1, 3:] - gt_end)
    assert err_after < 0.95 * err_before, (err_before, err_after)


def test_mesh_checks():
    mesh = _cpu_mesh(2)
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="shards"):
        tmesh.make_mesh(3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():        # decided inside the test
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()


# -- sharded replay ---------------------------------------------------------

_, TCFG = small_cfgs(mapping=dict(max_map_corner=2048, max_map_surf=4096,
                                  max_keyframes=32))


@pytest.fixture(scope="module")
def streams():
    """Four distinct streams of six scans (one mapping cycle each)."""
    per = []
    for b in range(4):
        scans, _, times = make_sequence(6, TCFG, seed=10 + b, noise=0.01,
                                        radius=6.0 + 0.5 * b)
        per.append(pack_sequence(scans, times, TCFG, device="cpu"))
    return per, tuple(torch.stack([p[k] for p in per]) for k in range(3))


def test_replay_sharded_matches_per_stream_replay(streams):
    per, (x, v, t) = streams
    states, outs = tmesh.replay_sharded(x, v, t, TCFG,
                                        _cpu_mesh(2))
    assert len(states) == 4 and outs["fused"].shape == (4, 6, 6)
    for b in range(4):
        state, ref = tslam.replay(*per[b], TCFG, device="cpu")
        for name in ref:
            assert torch.equal(outs[name][b], ref[name]), (b, name)
        assert torch.equal(states[b].mapping.meta.kf_pose,
                           state.mapping.meta.kf_pose)
    assert (outs["fused"][0] - outs["fused"][3]).abs().max() > 0.01


def test_replay_sharded_raises_what_a_shard_raised(streams, monkeypatch):
    _, (x, v, t) = streams
    with pytest.raises(ValueError, match="divide"):
        tmesh.replay_sharded(x[:3], v[:3], t[:3], TCFG,
                             _cpu_mesh(2))

    real = tmesh.batched_replay

    def failing(xs, *args, **kw):
        if torch.equal(xs[0], x[2, :1]):
            raise FloatingPointError("shard 1 failed")
        return real(xs, *args, **kw)
    monkeypatch.setattr(tmesh, "batched_replay", failing)
    with pytest.raises(FloatingPointError, match="shard 1"):
        tmesh.replay_sharded(x[:, :1], v[:, :1], t[:, :1], TCFG,
                             _cpu_mesh(2))


# a loop-closing lap (the geometry of tests/test_torch_cli.py's): every
# accepted closure re-solves; a small graph (16 keyframes + 8 loop slots)
# spreads its factors over the shards
_, LAP = small_cfgs(
    laser=dict(num_horizontal_scans=450),
    mapping=dict(enable_loop_closure=True, loop_closure_time_gap=4.0,
                 loop_relin_trans=-1.0, max_keyframes=16,
                 max_loop_factors=8, max_map_corner=2048,
                 max_map_surf=4096, loop_history_cap=16384,
                 icp_max_iters=30))


def test_replay_with_a_mesh_runs_the_sharded_solve():
    """``replay(mesh=…)``: the re-solve after the lap's loop closure (at scan
    49) runs factor-sharded over 3 CPU shards (24 factor slots, 8 a shard),
    and the keyframe blocks are row-sharded over them (16 rows: 6 + 6 + 4,
    10 written);
    the run equals the one without a mesh in its counts and within 1e-3 rad
    / 1e-3 m in every fused pose (the sharded sums may round differently),
    and its blocks, reassembled, equal the other run's bit for bit (they
    hold sensor-frame clouds, which no pose enters).  Both runs continue
    one state replayed to scan 45, each from its own copy (``replay_from``
    writes the keyframe blocks in place; a whole store is placed on the
    mesh)."""
    scans, _, times = make_sequence(50, LAP, seed=33, noise=0.01,
                                    radius=2.2, speed=1.6)
    x, v, t = pack_sequence(scans, times, LAP, device="cpu")
    head, _ = tslam.replay(x[:45], v[:45], t[:45], LAP, device="cpu")
    tree = convert.to_numpy_tree(head)

    def tail(**kw):
        state = convert.from_numpy_tree("SlamState", tree, device="cpu")
        return tslam.replay_from(state, x[45:], v[45:], t[45:], LAP,
                                 device="cpu", **kw)
    resolves = tmapping.resolve_count
    state, outs = tail()
    plain_resolves = tmapping.resolve_count - resolves
    assert plain_resolves >= 1
    solves = sharded_pgo.solve_count
    mesh = _cpu_mesh(3)
    mstate, mouts = tail(mesh=mesh)
    assert sharded_pgo.solve_count - solves == plain_resolves
    for name in ("kf_count", "factor_count"):
        assert torch.equal(mouts[name], outs[name]), name
    assert int(mstate.mapping.meta.factor_count) \
        > int(mstate.mapping.meta.kf_count) - 1          # a loop factor
    d = (mouts["fused"] - outs["fused"]).abs()
    assert float(d[:, :3].max()) < 1e-3 and float(d[:, 3:].max()) < 1e-3
    clouds = mstate.mapping.clouds
    assert int(mstate.mapping.meta.kf_count) > 6      # rows past shard 0
    for name, blk in vars(state.mapping.clouds).items():
        sharded = getattr(clouds, name)
        assert isinstance(sharded, keyframes.RowShards), name
        assert [p.shape[0] for p in sharded.parts] == [6, 6, 4], name
        assert torch.equal(keyframes.whole(sharded), blk), name
    assert not isinstance(state.mapping.clouds.corner, keyframes.RowShards)


def test_host_read_count_is_exact_under_threads():
    """8 threads x 1000 counted reads, with a short switch interval so the
    threads interleave inside the count: exactly 8000."""
    flag = torch.ones((), dtype=torch.bool)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tdevice.reset_sync_count()
        threads = [threading.Thread(
            target=lambda: [tdevice.host_bool(flag) for _ in range(1000)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert tdevice.sync_count() == 8000
    finally:
        sys.setswitchinterval(interval)

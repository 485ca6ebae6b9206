"""The keyframe store row-sharded over a mesh (``graph/keyframes.py``:
``RowShards``, ``take_rows``, ``put_row_``, ``whole``), on the CPU.

A store of K = 16 rows, its poses, stamps and clouds drawn from a seeded
NumPy generator, is cut over 1, 2 and 3 CPU shards (6 + 6 + 4 rows: the last
shard is short).  Every reader of the blocks gives, from the sharded store,
the bits it gives from the whole store; a write lands in its owner shard
only; placing, assembling, ``convert`` and the checkpoint carry the whole
arrays.  The pipeline's meshed replay is held to the JAX package's at the
size of ``tests/test_distributed.py::test_sharded_pipeline_single_stream``
(6 scans, seed 2, 8 shards): fused poses within 1e-5, as that test holds
the JAX package's to its own unsharded replay."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from lego_loam_tpu.io.npz_io import pack_sequence as jpack_sequence
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.distributed.mesh import make_mesh
from lego_loam_tpu_torch.graph import keyframes as kf
from lego_loam_tpu_torch.graph import submap_grid
from lego_loam_tpu_torch.io import checkpoint
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.loop import detect
from lego_loam_tpu_torch.map2d.grid import build_occupancy_grid
from lego_loam_tpu_torch.pipeline import slam as tslam
from tests.test_distributed import _tiny_cfg
from tests.test_torch_distributed import LAP
from torch_port_util import port_cfg, tnp

K = LAP.mapping.max_keyframes
COUNT = 14                   # rows 14-15 stay empty
SHARDS = (1, 2, 3)
# a small 2-D grid: the readers' bits, not the grid's reach, are tested
CFG = LAP.replace(grid2d=dataclasses.replace(LAP.grid2d, max_cells=256))


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _random_clouds(rng) -> kf.KeyframeClouds:
    def block(cap):
        pts = rng.uniform(-15.0, 15.0, (K, cap, 3)).astype(np.float32)
        pts[..., 2] *= 0.1
        ok = rng.random((K, cap)) < 0.7
        ok[COUNT:] = False
        pts[~ok] = 0.0
        return (torch.from_numpy(pts.reshape(K, cap * 3)),
                torch.from_numpy(ok))
    names = ("corner", "surf", "outlier", "scan2d")
    caps = (kf.CORNER_CAP, kf.SURF_CAP, kf.OUTLIER_CAP, kf.SCAN2D_CAP)
    out = {}
    for name, cap in zip(names, caps):
        out[name], out[name + "_valid"] = block(cap)
    return kf.KeyframeClouds(**out)


@pytest.fixture(scope="module")
def store():
    """K rows, COUNT of them alive: keyposes 0.8 m apart on an arc (so the
    radius gates take some and not others), stamps 1 s apart."""
    rng = np.random.default_rng(7)
    pose = np.zeros((K, 6), np.float32)
    a = np.arange(COUNT) * 0.3
    pose[:COUNT, 2] = a
    pose[:COUNT, 3] = 2.7 * np.sin(a)
    pose[:COUNT, 4] = 2.7 * (1 - np.cos(a))
    pose[:COUNT, :2] = rng.normal(0, 0.01, (COUNT, 2))
    stamp = np.where(np.arange(K) < COUNT, np.arange(K, dtype=np.float32),
                     0.0).astype(np.float32)
    return kf.KeyframeStore(
        pose=torch.from_numpy(pose), stamp=torch.from_numpy(stamp),
        count=torch.tensor(COUNT, dtype=torch.int32),
        clouds=_random_clouds(rng))


def _sharded(store, n):
    return store.replace(clouds=kf.place_clouds(store.clouds, _mesh(n)))


def _row(store, idx):
    """The keyframe payload of row 3 under index ``idx``."""
    def pts(name):
        return kf.as_points(kf.take_row(getattr(store, name),
                                        torch.tensor(3)))
    return kf.make_row(
        torch.tensor(idx, dtype=torch.int32),
        pts("corner"), kf.take_row(store.corner_valid, torch.tensor(3)),
        pts("surf"), kf.take_row(store.surf_valid, torch.tensor(3)),
        pts("outlier"), kf.take_row(store.outlier_valid, torch.tensor(3)),
        pts("scan2d"), kf.take_row(store.scan2d_valid, torch.tensor(3)))


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return [getattr(out, f.name) for f in dataclasses.fields(out)]
    return [t for o in out for t in _flat(o)]


READERS = {
    "assemble_submap": lambda s: kf.assemble_submap(
        s, s.pose[5], CFG, window=6, with_sat=True),
    "assemble_global_map": lambda s: kf.assemble_global_map(
        s, s.pose[7], CFG, max_frames=12, capacity=16384),
    "rebuild": lambda s: submap_grid.rebuild(
        s.pose, s.count, s.clouds, CFG, window=8),
    "gather_history": lambda s: detect._gather_history(
        s, _row(s, COUNT - 1), torch.tensor(9), CFG),
    "gather_latest": lambda s: detect._gather_latest(
        s, None, torch.tensor(COUNT - 1), CFG.mapping.loop_source_cap),
    "occupancy_grid": lambda s: build_occupancy_grid(
        s, s.pose.mean(0), CFG, max_frames=16),
}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_on_a_sharded_store_equals_the_whole(store, reader, shards):
    whole = _flat(READERS[reader](store))
    sharded = _flat(READERS[reader](_sharded(store, shards)))
    assert len(whole) == len(sharded) >= 2
    for k, (a, b) in enumerate(zip(whole, sharded)):
        assert a.dtype == b.dtype and torch.equal(a, b), (reader, k)
    assert any(bool((t != 0).any()) for t in whole)


@pytest.mark.parametrize("shards", SHARDS)
def test_each_shard_holds_exactly_its_rows(store, shards):
    r = -(-K // shards)
    sharded = kf.place_clouds(store.clouds, _mesh(shards))
    for name, blk in vars(store.clouds).items():
        parts = getattr(sharded, name).parts
        assert [p.shape[0] for p in parts] == \
            [min(r, K - s * r) for s in range(shards)], name
        for s, p in enumerate(parts):
            assert torch.equal(p, blk[s * r:(s + 1) * r]), (name, s)
        assert torch.equal(kf.whole(getattr(sharded, name)), blk), name


def test_take_rows_keeps_index_order_and_repeats(store):
    idx = torch.tensor([15, 0, 6, 5, 6, 11, 12, 0, 4])
    sharded = kf.place_clouds(store.clouds, _mesh(3))
    for name, blk in vars(store.clouds).items():
        got = kf.take_rows(getattr(sharded, name), idx)
        assert torch.equal(got, blk[idx]), name


@pytest.mark.parametrize("idx", [0, 5, 6, 12, 15, K])
def test_apply_row_writes_only_the_owner_shard(store, idx):
    """Row 3's payload written at ``idx`` over 3 shards (6 + 6 + 4): the
    owner shard takes it, the others keep their bits; ``idx == K`` (a
    dropped keyframe) writes nothing."""
    whole = kf.KeyframeClouds(**{n: b.clone()
                                 for n, b in vars(store.clouds).items()})
    sharded = kf.place_clouds(store.clouds, _mesh(3))
    row = _row(store, idx)
    kf.apply_row(whole, row)
    assert kf.apply_row(sharded, row) is sharded
    for name, blk in vars(store.clouds).items():
        want = blk.clone()
        if idx < K:
            want[idx] = getattr(row, name)
        got = getattr(sharded, name)
        for s, p in enumerate(got.parts):
            assert torch.equal(p, want[6 * s:6 * (s + 1)]), (name, s)
        assert torch.equal(getattr(whole, name), want), name
    assert (idx == K) == all(torch.equal(getattr(sharded, n).parts[s],
                                         b[6 * s:6 * (s + 1)])
                             for n, b in vars(store.clouds).items()
                             for s in range(3))


def test_a_mesh_with_more_shards_than_rows_raises(store):
    with pytest.raises(ValueError, match="17 shards over 16"):
        kf.shard_rows(store.corner, _mesh(17))
    with pytest.raises(ValueError, match="17 shards over 16"):
        kf.empty_clouds(CFG, "cpu", mesh=_mesh(17))
    # a trailing shard may hold no row (16 rows over 6 shards of 3)
    sharded = kf.shard_rows(store.corner, _mesh(6))
    assert [p.shape[0] for p in sharded.parts] == [3, 3, 3, 3, 3, 1]
    assert torch.equal(kf.take_rows(sharded, torch.arange(K)), store.corner)


@pytest.fixture(scope="module")
def lap_state():
    """The LAP config's state after 20 scans (4 mapping cycles)."""
    scans, _, times = make_sequence(20, LAP, seed=33, noise=0.01,
                                    radius=2.2, speed=1.6)
    x, v, t = pack_sequence(scans, times, LAP, device="cpu")
    state, _ = tslam.replay(x, v, t, LAP, device="cpu")
    return state


def test_place_assemble_convert_and_checkpoint_round_trip(lap_state,
                                                         tmp_path):
    tree = convert.to_numpy_tree(lap_state)
    placed = lap_state.replace(mapping=lap_state.mapping.replace(
        clouds=kf.place_clouds(lap_state.mapping.clouds, _mesh(3))))
    assert isinstance(placed.mapping.clouds.surf, kf.RowShards)
    assert kf.place_clouds(placed.mapping.clouds, _mesh(3)).surf \
        is placed.mapping.clouds.surf

    def equal(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for key in a:
                equal(a[key], b[key], f"{path}/{key}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), path
    equal(convert.to_numpy_tree(placed), tree)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, placed)
    back = checkpoint.load_state(path, tslam.init_state(LAP, "cpu"))
    equal(convert.to_numpy_tree(back), tree)
    assert not isinstance(back.mapping.clouds.surf, kf.RowShards)
    # placed anew on another mesh: the same rows
    replaced = kf.place_clouds(placed.mapping.clouds, _mesh(2))
    equal(convert.to_numpy_tree(replaced),
          convert.to_numpy_tree(lap_state.mapping.clouds))


@pytest.fixture(scope="module")
def tiny_sequence():
    jcfg = _tiny_cfg(enable_loop=True)
    scans, _, times = make_sequence(6, jcfg, seed=2, noise=0.01)
    return jcfg, scans, times


def test_meshed_replay_matches_jax_and_the_whole_store(tiny_sequence):
    """JAX ``replay(mesh=8 devices)`` against the port's ``replay(mesh=8
    CPU shards)``: fused poses within 1e-5 and keyframe counts equal; the
    port's meshed run equals its own run without a mesh bit for bit (no
    closure fires within 6 scans), its blocks sharded 8 rows a shard."""
    jcfg, scans, times = tiny_sequence
    assert len(jax.devices()) >= 8, "conftest must fan out 8 CPU devices"
    jmesh = JMesh(np.asarray(jax.devices()[:8]), axis_names=("pgo",))
    jstate, jouts = jslam.replay(*jpack_sequence(scans, times, jcfg), jcfg,
                                 mesh=jmesh)
    cfg = port_cfg(jcfg)
    x, v, t = pack_sequence(scans, times, cfg, device="cpu")
    state, outs = tslam.replay(x, v, t, cfg, device="cpu", mesh=_mesh(8))
    np.testing.assert_allclose(tnp(outs["fused"]),
                               np.asarray(jouts["fused"]), atol=1e-5)
    assert int(state.mapping.meta.kf_count) \
        == int(jstate.mapping.store.count) >= 1
    surf = state.mapping.clouds.surf
    assert isinstance(surf, kf.RowShards)
    assert [p.shape[0] for p in surf.parts] == [8] * 8
    plain_state, plain = tslam.replay(x, v, t, cfg, device="cpu")
    for name in plain:
        assert torch.equal(outs[name], plain[name]), name
    for name, blk in vars(plain_state.mapping.clouds).items():
        assert torch.equal(kf.whole(getattr(state.mapping.clouds, name)),
                           blk), name

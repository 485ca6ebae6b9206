"""PyTorch port vs JAX package: what the CLI writes and reads — the config
loader copy (``core/params.py``), the 2-D occupancy grid
(``map2d/grid.py``), the global map (``graph/keyframes.py``), checkpoints
(``io/checkpoint.py``), the artifact writers (``eval/artifacts.py``) — and
``run.main`` itself on the CPU, on a loop-closing lap, and its ``.bag``
and ``--streaming`` modes against its ``.npz`` run.

Tolerances, stated at each assert: config fields, occupancy counts, masks,
file bytes and checkpoint leaves exact; world-frame points 1e-4 (the pose
transform in float32 on both sides)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import params as jparams
from lego_loam_tpu.eval import artifacts as jart
from lego_loam_tpu.graph import keyframes as jkf
from lego_loam_tpu.io import checkpoint as jckpt
from lego_loam_tpu.map2d import grid as jgrid2d
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu_torch import run as trun
from lego_loam_tpu_torch.core import params as tparams
from lego_loam_tpu_torch.eval import artifacts as tart
from lego_loam_tpu_torch.graph import keyframes as tkf
from lego_loam_tpu_torch.io import checkpoint as tckpt
from lego_loam_tpu_torch.io.npz_io import pack_sequence, save_sequence
from lego_loam_tpu_torch.io.rosbag import write_bag
from lego_loam_tpu_torch.io.synthetic import make_sequence
from lego_loam_tpu_torch.map2d import grid as tgrid2d
from lego_loam_tpu_torch.pipeline import mapping as tmap
from lego_loam_tpu_torch.pipeline import slam as tslam
from torch_port_util import small_cfgs, tnp, to_np

JCFG, TCFG = small_cfgs()
GRID2D = dict(max_cells=256, max_ray_steps=256, resolution=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_params_copy_equals_original(tmp_path):
    """The port's own copy of the reference-YAML loader maps the same names
    onto the same config, and refuses the same unknown keys."""
    assert tparams._KEYMAP == jparams._KEYMAP
    params = {"lego_loam": {
        "laser": {"num_horizontal_scans": 900, "scan_period": 0.1},
        "imageProjection": {"segment_theta": 55.0},
        "mapping": {"enable_loop_closure": False,
                    "history_keyframe_fitness_score": 0.2}}}
    j = jparams.config_from_dict(params)
    t = tparams.config_from_dict(params)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.laser.num_horizontal_scans == 900
    for mod in (jparams, tparams):
        with pytest.raises(KeyError, match="unknown parameter"):
            mod.config_from_dict({"mapping": {"no_such_key": 1}})
    path = tmp_path / "cfg.yaml"
    path.write_text("lego_loam:\n  mapping:\n    mapping_frequency_divider: 3\n")
    assert dataclasses.asdict(tparams.config_from_yaml(str(path))) == \
        dataclasses.asdict(jparams.config_from_yaml(str(path)))


def _store(rng, n):
    """A keyframe store of ``n`` keyframes along an arc, with random clouds
    (scan2d a ring of virtual-scan points), made from ``rng``."""
    rows = []
    for k in range(n):
        a = 0.15 * k
        pose = np.array([0, 0, a + 0.3, 20 + 6 * np.cos(a),
                         5 + 6 * np.sin(a), 0.1], np.float32)
        ang = rng.uniform(-np.pi, np.pi, tkf.SCAN2D_CAP)
        r = rng.uniform(0.5, 14.0, tkf.SCAN2D_CAP)
        scan2d = np.stack([r * np.cos(ang), r * np.sin(ang),
                           np.full_like(r, 0.4)], 1).astype(np.float32)
        clouds = []
        for cap in (tkf.CORNER_CAP, tkf.SURF_CAP, tkf.OUTLIER_CAP):
            clouds += [rng.uniform(-8, 8, (cap, 3)).astype(np.float32),
                       rng.random(cap) > 0.4]
        clouds += [scan2d, rng.random(tkf.SCAN2D_CAP) > 0.3]
        rows.append((pose, np.float32(0.5 * k), clouds))
    return rows


@pytest.fixture(scope="module")
def stores():
    """The same 24-keyframe store on both sides."""
    rows = _store(np.random.default_rng(3), 24)
    js = jkf.empty_store(JCFG)
    ts = tkf.empty_store(TCFG, device="cpu")
    for pose, stamp, clouds in rows:
        js = jkf.insert_keyframe(js, jnp.asarray(pose), jnp.asarray(stamp),
                                 *map(jnp.asarray, clouds))
        ts = tkf.insert_keyframe(ts, _t(pose), torch.tensor(stamp),
                                 *map(_t, clouds))
    return js, ts


def test_rasterize_scans_matches_jax():
    """Random rays — leaving the grid, of zero length, with negative
    coordinates, invalid — give the same integer grid (exact)."""
    rng = np.random.default_rng(4)
    jc = JCFG.replace(grid2d=dataclasses.replace(JCFG.grid2d, **GRID2D))
    tc = TCFG.replace(grid2d=dataclasses.replace(TCFG.grid2d, **GRID2D))
    R = 3000
    origins = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    pts = (origins + rng.normal(0, 8, (R, 3))).astype(np.float32)
    pts[:50] = origins[:50]                                # zero length
    valid = rng.random(R) > 0.2
    origin = np.array([-12.8, -12.8], np.float32)
    ref = np.asarray(jgrid2d.rasterize_scans(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(origins),
        jnp.asarray(origin), jc))
    got = tnp(tgrid2d.rasterize_scans(_t(pts), _t(valid), _t(origins),
                                      _t(origin), tc))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got < 50).sum() > 1000 and (got > 50).sum() > 100


def test_occupancy_grid_and_global_map_match_jax(stores):
    """``build_occupancy_grid`` (keyframe choice by pose voxel, rays, log
    odds): the integer grid equal to the JAX package's except where the two
    float32 pose transforms put a ray sample within an ulp of a cell edge
    on different sides — at most 4 of 65,536 cells here (the rasterisation
    itself is exact on identical rays, see above); ``assemble_global_map``:
    masks exact, points 1e-4."""
    js, ts = stores
    jc = JCFG.replace(grid2d=dataclasses.replace(JCFG.grid2d, **GRID2D))
    tc = TCFG.replace(grid2d=dataclasses.replace(TCFG.grid2d, **GRID2D))
    center = np.asarray(js.pose[:24]).mean(0).astype(np.float32)
    jg, jo = jgrid2d.build_occupancy_grid(js, jnp.asarray(center), jc,
                                          max_frames=16)
    tg, to = tgrid2d.build_occupancy_grid(ts, _t(center), tc, max_frames=16)
    origin = np.asarray([14.0, -4.0], np.float32)
    jg2, _ = jgrid2d.build_occupancy_grid(js, jnp.asarray(center), jc,
                                          max_frames=16,
                                          origin=jnp.asarray(origin))
    tg2, _ = tgrid2d.build_occupancy_grid(ts, _t(center), tc, max_frames=16,
                                          origin=_t(origin))
    assert (tnp(tg2) != np.asarray(jg2)).sum() <= 4
    assert (tnp(tg) != np.asarray(jg)).sum() <= 4
    np.testing.assert_array_equal(tnp(to), np.asarray(jo))
    assert (tnp(tg) != 50).sum() > 1000

    jx, jok = jkf.assemble_global_map(js, jnp.asarray(center), JCFG,
                                      max_frames=32, capacity=16384)
    tx, tok = tkf.assemble_global_map(ts, _t(center), TCFG, max_frames=32,
                                      capacity=16384)
    np.testing.assert_array_equal(tnp(tok), np.asarray(jok))
    np.testing.assert_allclose(tnp(tx), np.asarray(jx), atol=1e-4)
    assert tnp(tok).sum() > 5000


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the JAX package writes loads into the port with every
    leaf equal, and one the port writes loads into the JAX package; a
    template of another layout is refused."""
    rng = np.random.default_rng(5)
    template = jslam.init_state(JCFG)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return jnp.asarray(rng.random(x.shape) > 0.5)
        return jnp.asarray((rng.random(x.shape) * 100).astype(x.dtype))

    import jax
    state = jax.tree.map(fill, template)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, state)
    got = tckpt.load_state(jpath, tslam.init_state(TCFG, device="cpu"))
    ref = to_np(state)

    def walk(a, b, path=""):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                walk(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        elif isinstance(a, int):
            assert a == int(b), path
        else:
            assert tnp(a).dtype == np.asarray(b).dtype, path
            np.testing.assert_array_equal(tnp(a), np.asarray(b),
                                          err_msg=path)

    walk(got, ref)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_state(tpath, got)
    back = to_np(jckpt.load_state(tpath, template))
    walk(got, back)
    small = tslam.init_state(TCFG.replace(mapping=dataclasses.replace(
        TCFG.mapping, max_keyframes=8)), device="cpu")
    with pytest.raises(ValueError, match="leaf"):
        tckpt.load_state(tpath, small)


def test_resume_from_a_checkpoint_is_bit_exact(tmp_path):
    """Replay 8 scans, checkpoint, load, replay 7 more: the same state and
    outputs as 15 scans in one go (bit for bit on the CPU)."""
    scans, _, times = make_sequence(15, TCFG, seed=7, noise=0.01, speed=1.2)
    x, v, t = pack_sequence(scans, times, TCFG, device="cpu")
    whole, wouts = tslam.replay(x, v, t, TCFG, device="cpu")
    half, _ = tslam.replay(x[:8], v[:8], t[:8], TCFG, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, half)
    resumed = tckpt.load_state(path, tslam.init_state(TCFG, device="cpu"))
    assert resumed.scan_index == 8
    final, outs = tslam.replay_from(resumed, x[8:], v[8:], t[8:], TCFG,
                                    device="cpu")
    for k in outs:
        assert torch.equal(outs[k], wouts[k][8:]), k
    a, b = tckpt._leaves(final), tckpt._leaves(whole)
    assert len(a) == len(b) == 44
    for (ka, va), (kb, vb) in zip(a, b):
        assert ka == kb
        if isinstance(va, int):
            assert va == vb, ka
        else:
            assert torch.equal(va, vb), ka


def test_artifact_writers_match_jax(tmp_path):
    """TUM trajectories and PGM files: the same bytes as the JAX
    package's writers for the same arrays."""
    rng = np.random.default_rng(6)
    poses = rng.normal(0, 1, (20, 6)).astype(np.float32)
    times = np.arange(20, dtype=np.float32) * 0.1
    grid = rng.integers(0, 101, (64, 48)).astype(np.int32)
    for mod, tag in ((jart, "j"), (tart, "t")):
        mod.write_tum_trajectory(str(tmp_path / f"{tag}.tum"), poses, times)
        mod.write_occupancy_pgm(str(tmp_path / f"{tag}.pgm"), grid)
    for ext in ("tum", "pgm"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes()


# a loop-closing lap: 1.5 s past the 4 s closure age at 1.6 m/s on a 2.2 m
# circle, 450 columns (the loop test geometry of the JAX package's suite);
# every accepted closure re-solves, so the solver and the grid rebuild run
_, LAP = small_cfgs(
    laser=dict(num_horizontal_scans=450),
    mapping=dict(enable_loop_closure=True, loop_closure_time_gap=4.0,
                 loop_relin_trans=-1.0, max_keyframes=256,
                 max_map_corner=2048, max_map_surf=4096,
                 loop_history_cap=16384, icp_max_iters=30))
# what the JAX CLI writes (eval/artifacts.py), plus --debug-scan's file
ARTIFACTS = ("trajectory_odom.tum", "trajectory_fused.tum",
             "trajectory_mapped.tum", "trajectory_gt.tum", "map2d.pgm",
             "map2d_origin.npy", "keyframe_poses.npy", "global_map.npy",
             "metrics.json", "scan_debug_3.npz")


def test_run_main_replays_a_loop_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m lego_loam_tpu_torch.run --input lap.npz --device cpu``
    (config: the lap's, in place of ``vlp16()``): loop closure on by
    default, at least one loop factor, every artifact of the JAX CLI
    written, the ATE in ``metrics.json`` and on stdout."""
    scans, gt, times = make_sequence(60, LAP, seed=33, noise=0.01,
                                     radius=2.2, speed=1.6)
    path = str(tmp_path / "lap.npz")
    save_sequence(path, scans, gt, times)
    monkeypatch.setattr(trun, "vlp16", lambda: LAP)
    out = tmp_path / "out"
    resolves = tmap.resolve_count
    rc = trun.main(["--input", path, "--output", str(out), "--device", "cpu",
                    "--debug-scan", "3"])
    assert rc == 0
    for name in ARTIFACTS:
        assert (out / name).is_file(), name
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["n_scans"] == 60
    assert metrics["loop_factors"] >= 1, metrics
    assert metrics["factors"] == metrics["keyframes"] - 1 \
        + metrics["loop_factors"]
    assert tmap.resolve_count > resolves
    assert metrics["kf_dropped"] == metrics["factor_dropped"] == 0
    assert metrics["map_voxel_sat"] == 0
    assert 0 < metrics["ate"]["rmse"] < 0.9, metrics["ate"]
    stdout = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(stdout)["rmse"] == metrics["ate"]["rmse"]
    kf = np.load(out / "keyframe_poses.npy")
    assert kf.shape == (metrics["keyframes"], 6) and np.isfinite(kf).all()
    pgm = (out / "map2d.pgm").read_bytes()
    assert pgm.startswith(b"P5\n")
    fused = np.loadtxt(out / "trajectory_fused.tum")
    assert fused.shape == (60, 8) and np.isfinite(fused).all()


@pytest.fixture(scope="module")
def npz_run(tmp_path_factory):
    """``run.main`` on an ``.npz`` of 15 scans (config: TCFG in place of
    ``vlp16()``), the reference the other input modes are held to."""
    tmp = tmp_path_factory.mktemp("modes")
    scans, gt, times = make_sequence(15, TCFG, seed=4, noise=0.01)
    save_sequence(str(tmp / "seq.npz"), scans, gt, times)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trun, "vlp16", lambda: TCFG)
        assert trun.main(["--input", str(tmp / "seq.npz"), "--output",
                          str(tmp / "npz"), "--device", "cpu"]) == 0
    return tmp, scans, times


@pytest.mark.parametrize("argv", [["--streaming"], ["--input", "seq.bag"]])
def test_run_main_refuses_what_is_not_ported(argv, npz_run, monkeypatch):
    """Named for what it held before the two modes were ported: the CLI
    refused ``--streaming`` and ``.bag`` input.  Both now run, and each
    gives the ``.npz`` run's keyframes, factors, keyframe poses, global map
    and fused trajectory bit for bit (the bag's stamps are taken relative
    to its first, which the synthetic sequence's already are)."""
    tmp, scans, times = npz_run
    if argv[0] == "--streaming":
        out = tmp / "streaming"
        argv = ["--input", str(tmp / "seq.npz"), "--streaming",
                "--publish-every", "1"]
    else:
        out = tmp / "bag"
        bag = str(tmp / "seq.bag")
        write_bag(bag, scans, [float(t) for t in times],
                  topic="/lidar_points")
        argv = ["--input", bag, "--topic", "/lidar_points"]
    monkeypatch.setattr(trun, "vlp16", lambda: TCFG)
    assert trun.main(argv + ["--output", str(out), "--device", "cpu"]) == 0
    ref = tmp / "npz"
    got_m = json.loads((out / "metrics.json").read_text())
    ref_m = json.loads((ref / "metrics.json").read_text())
    for key in ("n_scans", "keyframes", "factors", "loop_factors"):
        assert got_m[key] == ref_m[key], key
    for name in ("keyframe_poses.npy", "global_map.npy"):
        np.testing.assert_array_equal(np.load(out / name),
                                      np.load(ref / name), err_msg=name)
    for name in ("trajectory_fused.tum", "trajectory_odom.tum"):
        assert (out / name).read_text() == (ref / name).read_text(), name
    if "--streaming" in argv:
        assert got_m["latency"]["p50_ms"] > 0
        assert (out / "keyframe_poses_live.npy").is_file()
    else:
        assert "read_bag" in got_m["stages"]


def test_run_main_needs_a_card_unless_told(tmp_path):
    """Without ``--device`` the CLI asks for the CUDA card (decided inside
    the test: on a machine with a card this runs nothing)."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--synthetic", "2", "--output", str(tmp_path)])

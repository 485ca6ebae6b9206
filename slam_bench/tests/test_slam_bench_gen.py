"""The benchmark's input generator against the simulator the port ships
(``lego_loam_tpu_torch/io/synthetic.py``), on the CPU at a few small
sweeps."""

import dataclasses

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch.core.config import hdl64, vlp16
from lego_loam_tpu_torch.io import synthetic
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from slam_bench.gen.scans import Sweeps, pack
from slam_bench.gen.world import Circle, default_world, world_for

CPU = torch.device("cpu")


def _laser(cfg):
    return dataclasses.asdict(cfg.laser)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_world_copy_equals_original(seed):
    circle = Circle(radius=6.5, scans_per_lap=314, period=0.1)
    mine = world_for(seed, circle)
    orig = synthetic.default_world(seed, path_xy=circle.footprint())
    np.testing.assert_array_equal(mine.boxes, orig.boxes)
    np.testing.assert_array_equal(mine.cylinders, orig.cylinders)
    free = default_world(seed)
    np.testing.assert_array_equal(free.boxes,
                                  synthetic.default_world(seed).boxes)


def test_circle_closes_after_a_whole_number_of_scans():
    c = Circle(radius=10.0, scans_per_lap=314, period=0.1)
    np.testing.assert_allclose(c.pose_at(c.lap_s)[3:], c.pose_at(0.0)[3:],
                               atol=1e-9)
    assert abs(c.speed - 2.0) < 0.01


@pytest.mark.parametrize("make_cfg,width,scans,check", [
    (vlp16, 360, 24, (0, 11, 23)),
    (hdl64, 2083, 2, (1,)),
])
def test_sweeps_equal_the_simulator(make_cfg, width, scans, check):
    """Noise-free sweeps equal ``simulate_scan``'s within float64 rounding:
    the same rays miss, the hits agree to 1e-5 m after the cast to
    float32."""
    base = make_cfg()
    cfg = base.replace(laser=dataclasses.replace(
        base.laser, num_horizontal_scans=width))
    circle = Circle(radius=6.5, scans_per_lap=scans, period=0.1)
    world = world_for(3, circle)
    sw = Sweeps(_laser(cfg), circle, world, CPU)
    pts = sw.points(0.0, torch.Generator()).numpy()
    _, _, pose_fn = synthetic.circle_trajectory(
        scans, radius=circle.radius, speed=circle.speed, period=0.1)
    for i in check:
        ref = synthetic.simulate_scan(pose_fn, i * 0.1, cfg, world)
        fin = np.isfinite(ref).all(axis=1)
        np.testing.assert_array_equal(np.isfinite(pts[i]).all(axis=1), fin)
        assert fin.sum() > 0.5 * len(fin)
        np.testing.assert_allclose(pts[i][fin], ref[fin], rtol=0, atol=1e-5)


def _small_sweeps():
    cfg = vlp16().replace(laser=dataclasses.replace(
        vlp16().laser, num_horizontal_scans=180))
    circle = Circle(radius=6.5, scans_per_lap=6, period=0.1)
    return cfg, Sweeps(_laser(cfg), circle, world_for(11, circle), CPU)


def test_noise_is_drawn_from_the_seed():
    _, sw = _small_sweeps()

    def noised(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return sw.points(0.01, g)

    a, b, c = noised(5), noised(5), noised(6)
    fin = torch.isfinite(a).all(-1)
    assert torch.equal(a[fin], b[fin])
    assert not torch.equal(a[fin], c[fin])
    gap = (a[fin] - sw.points(0.0, torch.Generator())[fin]).norm(dim=-1)
    assert 0.005 < float(gap.std()) < 0.02


def test_pack_is_the_layout_of_pack_sequence():
    cfg, sw = _small_sweeps()
    pts = sw.points(0.01, torch.Generator())
    cap = pts.shape[1] + 17
    cfg = cfg.replace(pipeline=dataclasses.replace(cfg.pipeline,
                                                   max_points=cap))
    xyz, valid = pack(pts, cap)
    ref_xyz, ref_valid, _ = pack_sequence(list(pts.numpy()), [0.0] * len(pts),
                                          cfg, device="cpu")
    assert torch.equal(xyz, ref_xyz)
    assert torch.equal(valid, ref_valid)

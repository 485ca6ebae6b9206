"""PyTorch port vs JAX package at full HDL-64 geometry (64 x 2083 image,
``max_points`` 140032), stage by stage, on the first scans of the
``benchmarks/kitti64_drive.py`` sequence.

The JAX output of each stage feeds both sides of the next.  Tolerances:
projection and segmentation exact (ranges and the relative time rtol 1e-6 /
atol 1e-6: the two packages' norms round differently in the last bit);
feature picks: layout exact (``valid`` and ``ring``, banded layout too) and
at most ``MOVED_PICKS`` picks of a cloud at another point of the same ring
— the jitted JAX curvature adds its first two terms with one fused
multiply-add on the CPU, the port rounds twice, and a near-tie of two
curvatures can then go the other way (one flat pick of ~1,500 on this
scan); less-flat voxel centroids within 1e-5 (float sums in another
order).  Then
a JAX ``SlamState`` at ``hdl64()`` shapes, with and without the banded
layout, goes through ``convert.py`` into the port and back unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import config as jconfig
from lego_loam_tpu.frontend import features as jfeat
from lego_loam_tpu.frontend import projection as jproj
from lego_loam_tpu.frontend import segmentation as jseg
from lego_loam_tpu.io.npz_io import pack_raw_scan as jpack
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu.solve import odometry as jsolve
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.core import config as tconfig
from lego_loam_tpu_torch.frontend import features as tfeat
from lego_loam_tpu_torch.frontend import projection as tproj
from lego_loam_tpu_torch.frontend import segmentation as tseg
from lego_loam_tpu_torch.solve import odometry as tsolve
from torch_port_util import tnp, to_np, to_torch

# the kitti64_drive sequence (benchmarks/kitti64_drive.py:29-31)
DRIVE = dict(seed=13, noise=0.01, speed=2.0, radius=10.0)
# the banded layout needs the pick caps to be exactly V·picks·sectors
BANDED_CAPS = dict(odom_band_rings=4, max_sharp=768, max_less_sharp=7680,
                   max_flat=1536)
MOVED_PICKS = 2


def _banded(mod):
    cfg = mod.hdl64()
    return cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                   **BANDED_CAPS))


CONFIGS = {"full": (jconfig.hdl64(), tconfig.hdl64()),
           "banded": (_banded(jconfig), _banded(tconfig))}


@pytest.fixture(scope="module")
def stages():
    """JAX side, scan 1 of the drive: the packed scan, its image, its
    segmented cloud and the features of both layouts; and the full-layout
    features of scan 0, the cloud scan 1's odometry matches against."""
    jc = CONFIGS["full"][0]
    assert jc.laser.image_size == (64, 2083)
    scans, _, times = make_sequence(2, jc, **DRIVE)
    raws = [jpack(scans[k], float(times[k]), jc.pipeline.max_points)
            for k in range(2)]
    imgs = [jproj.project_scan(raw, jc) for raw in raws]
    projs = [jseg.segment_cloud(img, raw.stamp, jc)
             for img, raw in zip(imgs, raws)]
    feats = {k: jfeat.extract_features(projs[1].segmented, c[0])
             for k, c in CONFIGS.items()}
    feats["previous"] = jfeat.extract_features(projs[0].segmented, jc)
    return raws[1], imgs[1], projs[1], feats


def test_project_scan_at_hdl64(stages):
    raw, img, _, _ = stages
    ref = to_np(img)
    got = tproj.project_scan(to_torch("RawScan", raw), CONFIGS["full"][1])
    assert ref.valid.sum() > 100000
    np.testing.assert_array_equal(tnp(got.valid), ref.valid)
    np.testing.assert_array_equal(tnp(got.ground), ref.ground)
    np.testing.assert_array_equal(tnp(got.xyz), ref.xyz)
    np.testing.assert_allclose(tnp(got.rng), ref.rng, rtol=1e-6)


def test_segment_cloud_at_hdl64(stages):
    raw, img, proj, _ = stages
    ref = to_np(proj)
    got = tseg.segment_cloud(to_torch("RangeImage", img),
                             torch.tensor(float(raw.stamp)),
                             CONFIGS["full"][1])
    s, r = got.segmented, ref.segmented
    assert r.count.sum() > 20000
    np.testing.assert_array_equal(tnp(s.count), r.count)
    np.testing.assert_array_equal(tnp(s.col), r.col)
    np.testing.assert_array_equal(tnp(s.valid), r.valid)
    np.testing.assert_array_equal(tnp(s.is_ground), r.is_ground)
    np.testing.assert_array_equal(tnp(s.xyz), r.xyz)
    np.testing.assert_allclose(tnp(s.rng), r.rng, rtol=1e-6)
    np.testing.assert_allclose(tnp(s.rel_time), r.rel_time, atol=1e-6)
    np.testing.assert_array_equal(tnp(got.outlier_valid), ref.outlier_valid)
    np.testing.assert_array_equal(tnp(got.outlier_xyz), ref.outlier_xyz)
    np.testing.assert_array_equal(tnp(got.scan2d_valid), ref.scan2d_valid)


@pytest.mark.parametrize("layout", ["full", "banded"])
def test_extract_features_at_hdl64(stages, layout):
    _, _, proj, feats = stages
    ref = to_np(feats[layout])
    got = tfeat.extract_features(to_torch("SegmentedCloud", proj.segmented),
                                 CONFIGS[layout][1])
    assert ref.sharp.valid.sum() > 100 and ref.flat.valid.sum() > 200
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        g, r = getattr(got, name), getattr(ref, name)
        assert tnp(g.valid).shape == r.valid.shape, name
        np.testing.assert_array_equal(tnp(g.valid), r.valid, err_msg=name)
        if name == "less_flat":       # voxel centroids
            np.testing.assert_allclose(tnp(g.ring), r.ring, atol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(tnp(g.xyz), r.xyz, atol=1e-5,
                                       err_msg=name)
        else:                         # picks: identical layout
            np.testing.assert_array_equal(tnp(g.ring), r.ring, err_msg=name)
            moved = (np.any(tnp(g.xyz) != r.xyz, axis=-1)
                     | (tnp(g.rel_time) != r.rel_time))
            assert moved.sum() <= MOVED_PICKS, (name, np.nonzero(moved))


def test_two_step_odometry_at_hdl64(stages):
    """Scan 1 of the drive against scan 0 at ``hdl64()`` shapes, both
    sides on the JAX package's features: θ within ``test_torch_odometry``'s
    1e-4 rad / 1e-3 m (the full-geometry step of the HDL-64 gap,
    ``ROADMAP.md`` Queue D)."""
    _, _, _, feats = stages
    jc, tc = CONFIGS["full"]
    cur, prev = feats["full"], feats["previous"]
    ref = np.asarray(jsolve.two_step_odometry(
        jnp.zeros((6,), jnp.float32), cur.sharp, cur.flat, prev.less_sharp,
        prev.less_flat, jc))
    got = tsolve.two_step_odometry(
        torch.zeros((6,)), to_torch("FeatureCloud", cur.sharp),
        to_torch("FeatureCloud", cur.flat),
        to_torch("FeatureCloud", prev.less_sharp),
        to_torch("FeatureCloud", prev.less_flat), tc)
    assert np.abs(ref[3:]).max() > 0.05                     # it moved
    np.testing.assert_allclose(tnp(got)[:3], ref[:3], atol=1e-4)
    np.testing.assert_allclose(tnp(got)[3:], ref[3:], atol=1e-3)


@pytest.mark.parametrize("layout", ["full", "banded"])
def test_convert_roundtrip_at_hdl64(stages, layout):
    """A JAX state at hdl64() shapes, its odometry clouds filled with the
    scan's features, crosses into the port and back leaf for leaf."""
    _, _, _, feats = stages
    jc = CONFIGS[layout][0]
    f = feats[layout]
    js = jslam.init_state(jc)
    js = js.replace(odo=js.odo.replace(last_corner=f.less_sharp,
                                       last_surf=f.less_flat))
    ref = to_np(js)
    ts = convert.from_numpy_tree("SlamState", ref, device="cpu")
    assert ts.odo.last_corner.xyz.shape == (jc.feature.max_less_sharp, 3)
    assert int(ts.odo.last_corner.count) == int(f.less_sharp.count)
    back = convert.to_numpy_tree(ts)

    def walk(a, b, path=""):
        if dataclasses.is_dataclass(b):
            for field in dataclasses.fields(b):
                walk(a[field.name], getattr(b, field.name),
                     f"{path}.{field.name}")
        elif b is None:
            assert a is None, path
        else:
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(back, ref)

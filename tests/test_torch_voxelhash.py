"""PyTorch port vs JAX package on points one ulp from a cell edge.

Compiled JAX divides by a constant as a multiplication by its float32
reciprocal, and the two round differently for about one quotient in seven.
A point one ulp below a voxel edge (or a range-image row or column edge) can
therefore land in the neighbouring cell under a true division.  The port's
voxel filters and its projection multiply by ``recip32``; these tests put
points on such edges and expect the port to equal the jitted JAX functions
exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import config as jcfg
from lego_loam_tpu.core.types import RawScan as JRawScan
from lego_loam_tpu.frontend import projection as jproj
from lego_loam_tpu.match import voxelhash as jvox
from lego_loam_tpu_torch.core import config as tcfg
from lego_loam_tpu_torch.core.types import RawScan as TRawScan
from lego_loam_tpu_torch.frontend import projection as tproj
from lego_loam_tpu_torch.match import voxelhash as tvox
from torch_port_util import tnp

LEAF = 0.2


def _below_edges(n, leaf, seed):
    """(n, 3) points whose every coordinate is a non-zero multiple of
    ``leaf`` (as float32) moved one ulp down, each paired with points inside
    the voxels on both sides, so that a point assigned to the wrong voxel
    changes a centroid.  (Zero is left out: one ulp below it is subnormal,
    which XLA's CPU code flushes to zero.)"""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 400, (n, 3)) * rng.choice([-1, 1], (n, 3))
    edge = (k * np.float32(leaf)).astype(np.float32)
    below = np.nextafter(edge, np.float32(-np.inf))
    lo = (edge - np.float32(0.3 * leaf)).astype(np.float32)
    hi = (edge + np.float32(0.3 * leaf)).astype(np.float32)
    xyz = np.concatenate([below, lo, hi]).astype(np.float32)
    return xyz[rng.permutation(len(xyz))]


def _divides_differently(xyz, leaf):
    """How many coordinates a true division puts in another voxel than the
    reciprocal's product (the teeth of these tests)."""
    t = torch.from_numpy(xyz)
    return int(torch.sum(torch.floor(t / leaf)
                         != torch.floor(t * tvox.recip32(leaf))))


def test_recip32_is_what_jit_divides_by():
    x = _below_edges(2000, LEAF, 0)
    got = jax.jit(lambda v: jnp.floor(v / LEAF))(jnp.asarray(x))
    ref = torch.floor(torch.from_numpy(x) * tvox.recip32(LEAF))
    np.testing.assert_array_equal(np.asarray(got), tnp(ref))
    assert _divides_differently(x, LEAF) > 100


def test_voxel_downsample_on_the_motivating_points():
    """Three points: one ulp below the 27.2 edge, and one inside each
    neighbouring voxel.  The JAX filter groups the first with 27.3."""
    xyz = np.array([[27.199999, 0.1, 0.1], [27.3, 0.1, 0.1],
                    [27.1, 0.1, 0.1]], np.float32)
    valid = np.ones(3, bool)
    jx, jv = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid),
                                   LEAF, 8)
    tx, tv = tvox.voxel_downsample(torch.from_numpy(xyz),
                                   torch.from_numpy(valid), LEAF, 8)
    np.testing.assert_array_equal(tnp(tv), np.asarray(jv))
    np.testing.assert_array_equal(tnp(tx), np.asarray(jx))
    np.testing.assert_allclose(np.asarray(jx)[:2, 0], [27.1, 27.25],
                               atol=1e-5)


@pytest.mark.parametrize("capacity", [8192, 1024], ids=["roomy", "saturated"])
def test_voxel_downsample_at_voxel_edges(capacity):
    xyz = _below_edges(1500, LEAF, 1)
    assert _divides_differently(xyz, LEAF) > 100
    valid = np.random.default_rng(2).random(len(xyz)) > 0.05
    jx, jv, jn = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid),
                                       LEAF, capacity, with_count=True)
    tx, tv, tn = tvox.voxel_downsample(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), LEAF,
                                       capacity, with_count=True)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tnp(tv), np.asarray(jv))
    np.testing.assert_array_equal(tnp(tx), np.asarray(jx))


def test_voxel_downsample_with_payload_at_voxel_edges():
    xyz = _below_edges(1500, LEAF, 3)
    valid = np.ones(len(xyz), bool)
    payload = np.random.default_rng(4).random((len(xyz), 2)).astype(
        np.float32)
    ref = jvox.voxel_downsample_with_payload(
        jnp.asarray(xyz), jnp.asarray(payload), jnp.asarray(valid), LEAF,
        8192)
    got = tvox.voxel_downsample_with_payload(
        torch.from_numpy(xyz), torch.from_numpy(payload),
        torch.from_numpy(valid), LEAF, 8192)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(tnp(g), np.asarray(r))


@pytest.mark.parametrize("two_probe", [True, False])
def test_voxel_hash_downsample_at_voxel_edges(two_probe):
    xyz = _below_edges(1500, LEAF, 5)
    valid = np.ones(len(xyz), bool)
    payload = np.random.default_rng(6).random((len(xyz), 1)).astype(
        np.float32)
    ref = jvox.voxel_hash_downsample(
        jnp.asarray(xyz), jnp.asarray(payload), jnp.asarray(valid), LEAF,
        4096, two_probe=two_probe)
    got = tvox.voxel_hash_downsample(
        torch.from_numpy(xyz), torch.from_numpy(payload),
        torch.from_numpy(valid), LEAF, 4096, two_probe=two_probe)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(tnp(g), np.asarray(r))


def _points_at(vertical, horizon, rng):
    """Points at the given elevation and ``atan2(x, y)`` azimuth."""
    r = rng.uniform(3.0, 60.0, vertical.shape)
    xyz = np.stack([r * np.cos(vertical) * np.sin(horizon),
                    r * np.cos(vertical) * np.cos(horizon),
                    r * np.sin(vertical)], axis=1)
    return xyz.astype(np.float32)


def _project_both(name, xyz):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    valid = np.ones(len(xyz), bool)
    ref = jproj.project_scan(JRawScan(
        xyz=jnp.asarray(xyz), valid=jnp.asarray(valid),
        stamp=jnp.float32(0.0)), j)
    got = tproj.project_scan(TRawScan(
        xyz=torch.from_numpy(xyz), valid=torch.from_numpy(valid),
        stamp=torch.tensor(0.0)), t)
    return ref, got


@pytest.mark.parametrize("name", ["vlp16", "hdl64"])
def test_project_scan_at_column_edges(name):
    """Azimuths within a few ulps of the half-column edges where ``round``
    switches, at mid-row elevations: the same pixels as the JAX package."""
    laser = getattr(tcfg, name)().laser
    V, H = laser.image_size
    rng = np.random.default_rng(7)
    n = 12000
    row = rng.integers(0, V, n)
    vertical = (row + 0.5) * laser.ang_res_y - laser.ang_bottom
    col = rng.integers(0, H, n)
    edge = np.float32(0.5 * math.pi) - (col - H // 2 + 0.5) * np.float32(
        laser.ang_res_x)
    edge = edge.astype(np.float32)
    horizon = edge + rng.integers(-30, 31, n) * np.spacing(edge)
    xyz = _points_at(vertical, horizon, rng)
    h = torch.atan2(torch.from_numpy(xyz[:, 0]), torch.from_numpy(xyz[:, 1]))
    h = h - 0.5 * math.pi
    assert int(torch.sum(torch.round(h / laser.ang_res_x) != torch.round(
        h * tvox.recip32(laser.ang_res_x)))) > 20
    ref, got = _project_both(name, xyz)
    np.testing.assert_array_equal(tnp(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(tnp(got.xyz), np.asarray(ref.xyz))


def test_project_scan_at_row_edges():
    """Elevations within a few ulps of the HDL-64 row edges.  The two
    packages' ``arcsin`` differ in the last ulp for some inputs, which moves
    a point across an edge by itself; the comparison keeps the points whose
    elevation both compute to the same float, where only the division by
    the row pitch can differ."""
    name = "hdl64"
    laser = tcfg.hdl64().laser
    V, H = laser.image_size
    rng = np.random.default_rng(8)
    n = 30000
    row = rng.integers(1, V, n)
    edge = (row * np.float32(laser.ang_res_y)
            - np.float32(laser.ang_bottom)).astype(np.float32)
    vertical = edge + rng.integers(-30, 31, n) * np.spacing(edge)
    col = rng.integers(0, H, n)
    horizon = 0.5 * math.pi - (col - H // 2) * laser.ang_res_x
    xyz = _points_at(vertical, horizon, rng)

    def elevation_jax(p):              # as the JAX package's project_scan
        r = jnp.linalg.norm(p, axis=-1)
        return jnp.arcsin(jnp.clip(p[:, 2] / jnp.maximum(r, 1e-12), -1, 1))

    t = torch.from_numpy(xyz)
    r = tproj._norm3(t)
    el = torch.arcsin(torch.clamp(t[:, 2] / torch.clamp(r, min=1e-12), -1, 1))
    same = tnp(el) == np.asarray(jax.jit(elevation_jax)(jnp.asarray(xyz)))
    xyz = xyz[same]
    el = el[torch.from_numpy(same)] + laser.ang_bottom
    assert len(xyz) > 10000
    assert int(torch.sum(torch.floor(el / laser.ang_res_y) != torch.floor(
        el * tvox.recip32(laser.ang_res_y)))) > 50
    ref, got = _project_both(name, xyz)
    np.testing.assert_array_equal(tnp(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(tnp(got.xyz), np.asarray(ref.xyz))

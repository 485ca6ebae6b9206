"""PyTorch port of the banded (per-ring-window) odometry search.

The port's counterparts of ``tests/test_banded.py`` (ring-block oracle, band
windows, a known motion recovered at B = 4, a wide band equal to the exact
search), then parity with the JAX package on the same seeded inputs:
``ring_block`` and ``band`` exactly; the banded surf and corner searches'
``ok`` exactly and ``a``, ``u`` within 1e-5; ``two_step_odometry`` with the
band on within 1e-4 on θ; ``extract_features`` with the band on: the blocked
layouts' ``valid``, ``ring`` and ``xyz`` exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.core.config import vlp16 as jvlp16
from lego_loam_tpu.core.types import FeatureCloud as JCloud
from lego_loam_tpu.frontend import features as jfeat
from lego_loam_tpu.frontend.segmentation import image_projection as jproject
from lego_loam_tpu.io.npz_io import pack_raw_scan as jpack
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.match import banded as jband
from lego_loam_tpu.solve import odometry as jsolve
from lego_loam_tpu_torch.core.config import vlp16 as tvlp16
from lego_loam_tpu_torch.core.types import FeatureCloud as TCloud
from lego_loam_tpu_torch.core.types import SegmentedCloud
from lego_loam_tpu_torch.frontend import features as tfeat
from lego_loam_tpu_torch.match import banded as tband
from lego_loam_tpu_torch.solve import odometry as tsolve
from torch_port_util import small_cfgs, tnp, to_np, to_torch

V = 8            # rings in the miniature scene
THETA_ATOL = 1e-4
COORD_ATOL = 1e-5


def _arrays(xyz, ring, cap, blocked_cap=None):
    """Compact ring-ascending cloud arrays (the position-major layout:
    valid entries sorted by ring, invalids last); with ``blocked_cap``,
    (V, blocked_cap) ring blocks instead, flattened."""
    order = np.argsort(ring, kind="stable")
    xyz = np.asarray(xyz, np.float32)[order]
    ring = np.asarray(ring, np.float32)[order]
    if blocked_cap is None:
        n = xyz.shape[0]
        out = np.zeros((cap, 3), np.float32)
        rg = np.zeros((cap,), np.float32)
        vd = np.zeros((cap,), bool)
        out[:n], rg[:n], vd[:n] = xyz, ring, True
    else:
        out = np.zeros((V, blocked_cap, 3), np.float32)
        rg = np.zeros((V, blocked_cap), np.float32)
        vd = np.zeros((V, blocked_cap), bool)
        for r in range(V):
            sel = np.where(ring.astype(int) == r)[0][:blocked_cap]
            out[r, :len(sel)] = xyz[sel]
            rg[r, :len(sel)] = ring[sel]
            vd[r, :len(sel)] = True
        out, rg, vd = out.reshape(-1, 3), rg.reshape(-1), vd.reshape(-1)
    return out, rg, np.ones(rg.shape, np.float32), vd


def _both(arrays):
    """(JAX cloud, port cloud) of the same arrays."""
    xyz, ring, rel, valid = arrays
    j = JCloud(xyz=jnp.asarray(xyz), ring=jnp.asarray(ring),
               rel_time=jnp.asarray(rel), valid=jnp.asarray(valid))
    t = TCloud(xyz=torch.from_numpy(xyz), ring=torch.from_numpy(ring),
               rel_time=torch.from_numpy(rel), valid=torch.from_numpy(valid))
    return j, t


def _assert_same(got, ref):
    for name in ("xyz", "ring", "valid", "rel_time"):
        if hasattr(ref, name):
            np.testing.assert_array_equal(tnp(getattr(got, name)),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)


def test_ring_block_matches_numpy_oracle():
    """``ring_block`` = per-ring stable compaction with capacity
    truncation."""
    rng = np.random.default_rng(1)
    n, cap = 64, 6
    ring = np.sort(rng.integers(0, V, n)).astype(np.float32)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    _, cloud = _both(_arrays(xyz, ring, n + 8))
    blk = tband.ring_block(cloud, V, cap)
    x_s, r_s, v_s = tnp(cloud.xyz), tnp(cloud.ring), tnp(cloud.valid)
    for r in range(V):
        sel = np.where(v_s & (r_s.astype(int) == r))[0][:cap]
        assert tnp(blk.valid[r]).sum() == len(sel)
        np.testing.assert_array_equal(tnp(blk.xyz[r])[:len(sel)], x_s[sel])


def test_band_windows_and_validity():
    """Row v of ``band`` holds exactly rings v−B..v+B, edge rows clipped."""
    cap = 4
    xyz = np.zeros((V * cap, 3), np.float32)
    ring = np.repeat(np.arange(V), cap).astype(np.float32)
    xyz[:, 0] = ring                                    # x encodes the ring
    _, cloud = _both(_arrays(xyz, ring, V * cap))
    bd = tband.band(tband.ring_block(cloud, V, cap), 2)
    for v in range(V):
        here = tnp(bd.xyz[v])[tnp(bd.valid[v]), 0].astype(int)
        assert sorted(set(here)) == list(range(max(0, v - 2),
                                               min(V, v + 3)))


@pytest.mark.parametrize("presorted", [True, False])
def test_ring_block_and_band_match_jax(presorted):
    """Same seeded cloud on both sides: blocks and bands exactly equal.
    ``presorted=False`` gets a cloud in no particular order."""
    rng = np.random.default_rng(2)
    n, cap = 200, 20
    ring = rng.integers(0, V, n).astype(np.float32) + rng.random(n).astype(
        np.float32) * 0.9
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    arrays = _arrays(xyz, ring, n + 40)
    if not presorted:
        perm = rng.permutation(n + 40)
        arrays = tuple(a[perm] for a in arrays)
    jc, tc = _both(arrays)
    jb = jband.ring_block(jc, V, cap, presorted=presorted)
    tb = tband.ring_block(tc, V, cap, presorted=presorted)
    _assert_same(tb, jb)
    assert tnp(tb.valid).sum() > 100
    _assert_same(tband.ring_block_from_layout(tb.as_cloud(), V),
                 jband.ring_block_from_layout(jb.as_cloud(), V))
    for B in (1, 3):
        _assert_same(tband.band(tb, B), jband.band(jb, B))


def test_masked_argmin_takes_the_first_minimum():
    d2 = torch.tensor([[[3.0, 1.0, 1.0, 0.5, 0.5]]])
    ok = torch.tensor([[[True, True, True, False, False]]])
    idx, dmin = tband.masked_argmin(d2, ok)
    assert idx.tolist() == [[1]] and dmin.tolist() == [[1.0]]
    idx, _ = tband.masked_argmin(d2, torch.zeros_like(ok))
    assert idx.tolist() == [[0]]


def _scene():
    """Plane + pole scene with per-ring counts under the frontend's pick
    maxima (flat ≤ 24/ring, sharp ≤ 12/ring), as in tests/test_banded.py."""
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(2, 10, 12), np.linspace(-6, 6, 12))
    surf = np.stack([gx.ravel(), gy.ravel(),
                     np.full(gx.size, -0.8)], 1).astype(np.float32)
    surf_ring = np.tile(np.arange(V), surf.shape[0] // V)
    corners, cring = [], []
    for px, py in rng.uniform(-8, 8, (8, 2)):
        if abs(px) < 2 and abs(py) < 2:
            px += 4
        for r in range(V):
            corners.append([px, py, -0.5 + 0.25 * r])
            cring.append(r)
    return (surf, np.asarray(surf_ring, np.float32),
            np.asarray(corners, np.float32), np.asarray(cring, np.float32))


THETA_TRUE = np.array([0.01, -0.008, 0.03, 0.12, 0.05, 0.02], np.float32)


def _scene_inputs(band_rings):
    """(JAX cfg, port cfg, [(JAX cloud, port cloud)] for sharp, flat,
    last_corner, last_surf): every cloud ring-blocked at capacity // V."""
    surf, surf_ring, corner, cring = _scene()
    cfgs = []
    for make in (jvlp16, tvlp16):
        cfg = make()
        cfgs.append(cfg.replace(
            laser=dataclasses.replace(cfg.laser, num_vertical_scans=V),
            feature=dataclasses.replace(cfg.feature,
                                        odom_band_rings=band_rings,
                                        max_less_flat=V * 64)))
    f = cfgs[1].feature
    moved = lambda p: np.asarray(jse3.apply_inverse(jnp.asarray(THETA_TRUE),
                                                    jnp.asarray(p)))
    clouds = [_both(_arrays(moved(corner), cring, None,
                            blocked_cap=f.max_sharp // V)),
              _both(_arrays(moved(surf), surf_ring, None,
                            blocked_cap=f.max_flat // V)),
              _both(_arrays(corner, cring, None,
                            blocked_cap=f.max_less_sharp // V)),
              _both(_arrays(surf, surf_ring, None, blocked_cap=64))]
    return cfgs[0], cfgs[1], clouds


def _recover(band_rings):
    _, tcfg, clouds = _scene_inputs(band_rings)
    theta = tsolve.two_step_odometry(torch.zeros(6), *[c[1] for c in clouds],
                                     tcfg)
    return tnp(theta)


def test_banded_recovers_known_motion_production_band():
    err = np.abs(_recover(band_rings=4) - THETA_TRUE)
    assert err[:3].max() < 0.01, err
    assert err[3:].max() < 0.03, err


def test_banded_wide_band_matches_exact_search():
    """B ≥ V−1 covers every candidate: banded and exact searches see the
    same correspondence set, so the solved motions agree closely."""
    np.testing.assert_allclose(_recover(band_rings=V - 1),
                               _recover(band_rings=0), atol=5e-3)


@pytest.mark.parametrize("band_rings", [2, 4])
def test_two_step_odometry_banded_matches_jax_on_the_scene(band_rings):
    jcfg, tcfg, clouds = _scene_inputs(band_rings)
    ref = jsolve.two_step_odometry(jnp.zeros(6, jnp.float32),
                                   *[c[0] for c in clouds], jcfg)
    got = tsolve.two_step_odometry(torch.zeros(6), *[c[1] for c in clouds],
                                   tcfg)
    np.testing.assert_allclose(tnp(got), np.asarray(ref), atol=THETA_ATOL)


# -- the frontend's blocked layout and the searches on real scans --------

BAND = 4
# pick caps of the blocked layout: exactly V·picks·sectors (16 rings)
JCFG, TCFG = small_cfgs(feature=dict(odom_band_rings=BAND, max_sharp=192,
                                     max_less_sharp=1920, max_flat=384))


@pytest.fixture(scope="module")
def scans():
    """JAX side: two consecutive scans projected, features extracted with
    the band on (the blocked layout)."""
    pts, _, times = make_sequence(2, JCFG, seed=6, noise=0.01, speed=1.2)
    out = []
    for p, t in zip(pts, times):
        proj = jproject(jpack(p, float(t), JCFG.pipeline.max_points), JCFG)
        out.append((proj, jfeat.extract_features(proj.segmented, JCFG)))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_extract_features_blocked_layout_matches_jax(scans, k):
    proj, ref = scans[k]
    got = tfeat.extract_features(to_torch("SegmentedCloud", proj.segmented),
                                 TCFG)
    ref = to_np(ref)
    assert ref.sharp.valid.sum() > 10 and ref.flat.valid.sum() > 10
    for name in ("sharp", "less_sharp", "flat"):
        g, r = getattr(got, name), getattr(ref, name)
        np.testing.assert_array_equal(tnp(g.valid), r.valid, err_msg=name)
        np.testing.assert_array_equal(tnp(g.ring), r.ring, err_msg=name)
        np.testing.assert_array_equal(tnp(g.xyz), r.xyz, err_msg=name)
        np.testing.assert_array_equal(tnp(g.rel_time), r.rel_time,
                                      err_msg=name)
    # ring v's picks in rows [v·cap, (v+1)·cap), valid ones first
    V16 = TCFG.laser.num_vertical_scans
    ring = tnp(got.sharp.ring).reshape(V16, -1)
    assert np.all(ring == np.arange(V16)[:, None])
    valid = tnp(got.sharp.valid).reshape(V16, -1)
    assert np.all(np.diff(valid.astype(int), axis=1) <= 0)


def test_blocked_layout_needs_exact_caps():
    _, tcfg = small_cfgs(feature=dict(odom_band_rings=BAND))
    idxs = torch.zeros((2, 16, 6), dtype=torch.int64)
    have = torch.zeros((2, 16, 6), dtype=torch.bool)
    fake = SegmentedCloud(
        xyz=torch.zeros((16, 8, 3)), rng=torch.zeros((16, 8)),
        col=torch.zeros((16, 8), dtype=torch.int32),
        is_ground=torch.zeros((16, 8), dtype=torch.bool),
        valid=torch.zeros((16, 8), dtype=torch.bool),
        count=torch.zeros(16, dtype=torch.int32),
        rel_time=torch.zeros((16, 8)))
    with pytest.raises(AssertionError):
        tfeat._blocked_from_picks(fake, idxs, have, tcfg.feature.max_sharp)
    out = tfeat._blocked_from_picks(fake, idxs, have, 16 * 2 * 6)
    assert out.valid.shape == (192,) and not bool(out.valid.any())


@pytest.mark.parametrize("kind", ["surf", "corner"])
def test_banded_searches_match_jax(scans, kind):
    (_, last), (_, cur) = scans
    V16 = JCFG.laser.num_vertical_scans
    theta = jnp.asarray([0.002, -0.003, 0.01, 0.05, -0.02, 0.01],
                        jnp.float32)
    if kind == "surf":
        query, cands = cur.flat, last.less_flat
        jmake, tmake = (jsolve._make_search_surf_banded,
                        tsolve._make_search_surf_banded)
    else:
        query, cands = cur.sharp, last.less_sharp
        jmake, tmake = (jsolve._make_search_corner_banded,
                        tsolve._make_search_corner_banded)
    qc = query.valid.shape[0] // V16
    jc = jband.band(jband.ring_block_from_layout(cands, V16), BAND)
    tc = tband.band(tband.ring_block_from_layout(
        to_torch("FeatureCloud", cands), V16), BAND)
    _assert_same(tc, jc)
    ref = jmake(jc, V16, qc)(theta, query, None, JCFG)
    got = tmake(tc, V16, qc)(torch.from_numpy(np.array(theta)),
                             to_torch("FeatureCloud", query), None, TCFG)
    ok = np.asarray(ref.ok)
    assert ok.sum() > 20
    np.testing.assert_array_equal(tnp(got.ok), ok)
    np.testing.assert_allclose(tnp(got.a), np.asarray(ref.a),
                               atol=COORD_ATOL)
    np.testing.assert_allclose(tnp(got.u), np.asarray(ref.u),
                               atol=COORD_ATOL)


def test_two_step_odometry_banded_matches_jax_on_scans(scans):
    (_, last), (_, cur) = scans
    theta0 = jnp.asarray([0.0, 0.0, 0.005, 0.08, 0.0, 0.0], jnp.float32)
    args = (cur.sharp, cur.flat, last.less_sharp, last.less_flat)
    ref = jsolve.two_step_odometry(theta0, *args, JCFG)
    got = tsolve.two_step_odometry(
        torch.from_numpy(np.array(theta0)),
        *[to_torch("FeatureCloud", c) for c in args], TCFG)
    assert np.abs(np.asarray(ref) - np.asarray(theta0)).max() > 1e-3
    np.testing.assert_allclose(tnp(got), np.asarray(ref), atol=THETA_ATOL)

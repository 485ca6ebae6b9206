"""PyTorch port vs JAX package: scan-to-scan odometry solver and step.

Both sides get the same JAX-made feature clouds.  θ agrees to 1e-4 rad /
1e-3 m: the two run the same Gauss-Newton iterations, but sums over
hundreds of residual rows are taken in another order and the Jacobian is
closed-form here and traced there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import config as jcfg
from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.core.types import FeatureCloud as JFeatureCloud
from lego_loam_tpu.frontend.segmentation import image_projection as jproject
from lego_loam_tpu.io.npz_io import pack_raw_scan as jpack
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.pipeline import odometry as jodo
from lego_loam_tpu.solve import odometry as jsolve
from lego_loam_tpu_torch.core.types import FeatureCloud
from lego_loam_tpu_torch.pipeline import odometry as todo
from lego_loam_tpu_torch.solve import odometry as tsolve
from torch_port_util import small_cfgs, tnp, to_np, to_torch

JCFG, TCFG = small_cfgs()
ROT_ATOL, TRANS_ATOL = 1e-4, 1e-3


def _assert_pose_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[:3], ref[:3], atol=ROT_ATOL)
    np.testing.assert_allclose(got[3:], ref[3:], atol=TRANS_ATOL)


@pytest.fixture(scope="module")
def stepped():
    """JAX side: three consecutive scans through projection and odometry;
    keeps the state before the last step and the last projection."""
    scans, _, times = make_sequence(3, JCFG, seed=4, noise=0.01, speed=1.2)
    state = jodo.init_state(JCFG)
    trace = []
    for pts, t in zip(scans, times):
        raw = jpack(pts, float(t), JCFG.pipeline.max_points)
        proj = jproject(raw, JCFG)
        new_state, out = jodo.odometry_step(state, proj, JCFG)
        trace.append((state, proj, new_state, out))
        state = new_state
    return trace


@pytest.mark.parametrize("k", [0, 1, 2], ids=["first", "second", "third"])
def test_odometry_step_matches_jax(stepped, k):
    """k = 0 is the initialisation frame, 1 and 2 are solved frames."""
    state, proj, ref_state, ref_out = stepped[k]
    got_state, got_out = todo.odometry_step(
        to_torch("OdometryState", state), to_torch("ProjectionOut", proj),
        TCFG)
    ref_state, ref_out = to_np(ref_state), to_np(ref_out)
    assert bool(got_state.initialized)
    _assert_pose_close(tnp(got_state.transform_cur), ref_state.transform_cur)
    _assert_pose_close(tnp(got_out.odom), ref_out.odom)
    if k:
        assert np.abs(ref_state.transform_cur).max() > 0.01     # it moved
    np.testing.assert_array_equal(tnp(got_out.corner_valid),
                                  ref_out.corner_valid)
    np.testing.assert_array_equal(tnp(got_out.surf_valid), ref_out.surf_valid)
    np.testing.assert_allclose(tnp(got_out.corner_xyz), ref_out.corner_xyz,
                               atol=5e-3)
    np.testing.assert_allclose(tnp(got_out.surf_xyz), ref_out.surf_xyz,
                               atol=5e-3)


def test_two_step_odometry_matches_jax(stepped):
    state, proj, _, _ = stepped[2]
    from lego_loam_tpu.frontend.features import extract_features
    feats = extract_features(proj.segmented, JCFG)
    ref = jsolve.two_step_odometry(
        state.transform_cur, feats.sharp, feats.flat, state.last_corner,
        state.last_surf, JCFG)
    got = tsolve.two_step_odometry(
        torch.from_numpy(np.array(state.transform_cur)),
        to_torch("FeatureCloud", feats.sharp),
        to_torch("FeatureCloud", feats.flat),
        to_torch("FeatureCloud", state.last_corner),
        to_torch("FeatureCloud", state.last_surf), TCFG)
    _assert_pose_close(tnp(got), ref)


def test_closed_form_jacobians_match_jacfwd(stepped):
    """The hand-written tangents of both residuals equal forward-mode AD
    of the JAX residual functions on real correspondences."""
    state, proj, _, _ = stepped[2]
    from lego_loam_tpu.frontend.features import extract_features
    feats = extract_features(proj.segmented, JCFG)
    theta = jnp.asarray([0.01, -0.02, 0.03, 0.1, -0.05, 0.02], jnp.float32)
    t_theta = torch.from_numpy(np.array(theta))
    for query, last, jsearch, jdist, tdist, free in (
            (feats.flat, state.last_surf, jsolve._search_surf,
             jsolve._surf_dist, tsolve._surf_dist, tsolve._SURF_FREE),
            (feats.sharp, state.last_corner, jsolve._search_corner,
             jsolve._corner_dist, tsolve._corner_dist, tsolve._CORNER_FREE)):
        corr = jsearch(theta, query, last, JCFG)
        assert int(np.asarray(corr.ok).sum()) > 10
        fidx = np.array(free)

        def r_of(fr):
            return jdist(theta.at[fidx].set(fr), query, last, corr)[0]

        J_ref = np.asarray(jax.jacfwd(r_of)(theta[fidx]))       # (N, D, 3)
        t_corr = tsolve._Corr(a=torch.from_numpy(np.array(corr.a)),
                              u=torch.from_numpy(np.array(corr.u)),
                              ok=torch.from_numpy(np.array(corr.ok)))
        r, _, _, J = tdist(t_theta, to_torch("FeatureCloud", query), t_corr,
                           free)
        np.testing.assert_allclose(tnp(J), J_ref, atol=1e-4)
        np.testing.assert_allclose(tnp(r), np.asarray(r_of(theta[fidx])),
                                   atol=1e-5)


def _cloud(xyz, ring, cap):
    n = xyz.shape[0]
    out = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap,), np.float32)
    rt = np.ones((cap,), np.float32)          # rel_time=1: full sensitivity
    vd = np.zeros((cap,), bool)
    out[:n], rg[:n], vd[:n] = xyz, ring, True
    return FeatureCloud(xyz=torch.from_numpy(out), ring=torch.from_numpy(rg),
                        rel_time=torch.from_numpy(rt),
                        valid=torch.from_numpy(vd))


def test_two_step_recovers_known_motion():
    """The scene of tests/test_odometry.py: ground-plane surf features +
    vertical-pole corner features moved by a known sweep motion."""
    from lego_loam_tpu_torch.core.config import vlp16
    cfg = vlp16()
    f = cfg.feature
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(2, 10, 24), np.linspace(-6, 6, 24))
    surf = np.stack([gx.ravel(), gy.ravel(),
                     np.full(gx.size, -0.8)], 1).astype(np.float32)
    surf_ring = np.tile(np.arange(4), surf.shape[0] // 4 + 1)[:surf.shape[0]]
    corners, cring = [], []
    for px, py in rng.uniform(-8, 8, (8, 2)):
        if abs(px) < 2 and abs(py) < 2:
            px += 4
        for r in range(8):
            corners.append([px, py, -0.5 + 0.25 * r])
            cring.append(r)
    corner = np.asarray(corners, np.float32)
    cring = np.asarray(cring, np.float32)

    theta_true = np.array([0.01, -0.008, 0.03, 0.12, 0.05, 0.02], np.float32)
    inv = lambda p: np.asarray(jse3.apply_inverse(jnp.asarray(theta_true),
                                                  jnp.asarray(p)))
    theta = tsolve.two_step_odometry(
        torch.zeros(6), _cloud(inv(corner), cring, f.max_sharp * 2),
        _cloud(inv(surf), surf_ring, f.max_flat * 2),
        _cloud(corner, cring, f.max_less_sharp),
        _cloud(surf, surf_ring, f.max_less_flat), cfg)
    err = np.abs(tnp(theta) - theta_true)
    assert err[:3].max() < 0.01, err           # rotations within 0.6 deg
    assert err[3:].max() < 0.03, err           # translations within 3 cm


def test_odometry_skips_thin_clouds_and_refuses_banded():
    import dataclasses
    from lego_loam_tpu_torch.core.config import vlp16
    cfg = vlp16()
    f = cfg.feature
    none = np.zeros((0, 3), np.float32)
    theta0 = torch.tensor([0.0, 0.0, 0.1, 0.5, 0.0, 0.0])
    theta = tsolve.two_step_odometry(
        theta0, _cloud(none, np.zeros(0), 64), _cloud(none, np.zeros(0), 64),
        _cloud(none, np.zeros(0), f.max_less_sharp),
        _cloud(none, np.zeros(0), f.max_less_flat), cfg)
    np.testing.assert_array_equal(tnp(theta), tnp(theta0))
    # the banded search is no longer refused: with thin (ring-blocked)
    # clouds it passes θ through, as the JAX package's ``where`` does
    banded = cfg.replace(feature=dataclasses.replace(f, odom_band_rings=4))
    clouds = [_cloud(none, np.zeros(0), 64) for _ in range(4)]
    theta = tsolve.two_step_odometry(theta0, *clouds, banded)
    np.testing.assert_array_equal(tnp(theta), tnp(theta0))
    jbanded = jcfg.vlp16()
    jbanded = jbanded.replace(feature=dataclasses.replace(
        jbanded.feature, odom_band_rings=4))
    ref = jsolve.two_step_odometry(
        jnp.asarray(tnp(theta0)),
        *[JFeatureCloud(**{k: jnp.asarray(tnp(getattr(c, k)))
                           for k in ("xyz", "ring", "rel_time", "valid")})
          for c in clouds], jbanded)
    np.testing.assert_array_equal(tnp(theta), np.asarray(ref))

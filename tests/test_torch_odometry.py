"""PyTorch port vs JAX package: scan-to-scan odometry solver and step.

Both sides get the same JAX-made feature clouds.  θ agrees to 1e-4 rad /
1e-3 m: the two run the same Gauss-Newton iterations, but sums over
hundreds of residual rows are taken in another order and the Jacobian is
closed-form here and traced there."""

import os
import sys
import threading

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
from lego_loam_tpu_torch.core import graphs
from lego_loam_tpu_torch.core.types import FeatureCloud
from lego_loam_tpu_torch.frontend import features as tfeat
from lego_loam_tpu_torch.frontend import segmentation as tseg
from lego_loam_tpu_torch.io import npz_io as tnpz
from lego_loam_tpu_torch.io import synthetic as tsynthetic
from lego_loam_tpu_torch.pipeline import odometry as todo
from lego_loam_tpu_torch.solve import odometry as tsolve
from torch_port_util import (graphs_replayed_on_cpu, leaves, small_cfgs,
                             storages, tnp, to_np, to_torch)

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


# ---------------------------------------------------------------------------
# The step as chains replayed from CUDA graphs (core/graphs.py): the same
# bits, and no result that aliases another's buffers
# ---------------------------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "odometry_four_steps.npz")
_CLOUD_FIELDS = ("xyz", "ring", "rel_time", "valid")


def _four_steps():
    """Four consecutive ``odometry_step`` calls on the CPU from a fresh
    state, over the port's own small sequence: θ of each solved step
    (``two_step_odometry`` on the step's inputs) and the state after each.
    Returns {name: array}."""
    scans, _, times = tsynthetic.make_sequence(4, TCFG, seed=4, noise=0.01,
                                               speed=1.2)
    state = todo.init_state(TCFG, "cpu")
    out = {}
    for k, (pts, t) in enumerate(zip(scans, times)):
        raw = tnpz.pack_raw_scan(pts, float(t), TCFG.pipeline.max_points,
                                 "cpu")
        proj = tseg.image_projection(raw, TCFG)
        if k:
            feats = tfeat.extract_features(proj.segmented, TCFG)
            out[f"theta_{k}"] = tsolve.two_step_odometry(
                state.transform_cur, feats.sharp, feats.flat,
                state.last_corner, state.last_surf, TCFG)
        state, _ = todo.odometry_step(state, proj, TCFG)
        out[f"transform_cur_{k}"] = state.transform_cur
        out[f"odom_{k}"] = state.odom
        for name in ("last_corner", "last_surf"):
            for field in _CLOUD_FIELDS:
                out[f"{name}.{field}_{k}"] = getattr(getattr(state, name),
                                                     field)
    return {k: tnp(v) for k, v in out.items()}


def test_odometry_steps_reproduce_the_golden_bits():
    """The step split into replayable chains computes what the unsplit
    step computed, bit for bit (``tests/data/odometry_four_steps.npz`` was
    written by :func:`_four_steps` before the split)."""
    got = _four_steps()
    with np.load(GOLDEN) as ref:
        assert sorted(ref.files) == sorted(got)
        for name in ref.files:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.fixture
def replayed_on_cpu():
    """``core/graphs.py``'s graph path on the CPU
    (``torch_port_util.graphs_replayed_on_cpu``): the runner's entries."""
    with graphs_replayed_on_cpu() as emulated:
        yield emulated.entries


def test_replayed_steps_keep_the_bits_and_own_their_results(replayed_on_cpu):
    """Through the graph path the four steps give the golden bits; every
    step's state and ``AssociationOut`` share storage neither with the
    state passed in nor with any graph's buffers, and a later step (which
    replays the same graphs) leaves an earlier step's results as they
    were."""
    with np.load(GOLDEN) as ref:
        golden = {k: ref[k] for k in ref.files}
    got = _four_steps()
    for name, want in golden.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    # the chains of a solved step each captured once: features, two
    # searches, two halves of an iteration a phase, the tail
    assert len(replayed_on_cpu) >= 8

    scans, _, times = tsynthetic.make_sequence(4, TCFG, seed=4, noise=0.01,
                                               speed=1.2)
    state = todo.init_state(TCFG, "cpu")
    kept = []
    for pts, t in zip(scans, times):
        raw = tnpz.pack_raw_scan(pts, float(t), TCFG.pipeline.max_points,
                                 "cpu")
        proj = tseg.image_projection(raw, TCFG)
        new_state, out = todo.odometry_step(state, proj, TCFG)
        buffers = set()
        for entry in replayed_on_cpu.values():
            buffers |= storages(entry.inputs) | storages(entry.outputs)
        mine = storages((new_state, out)) - storages(proj)
        assert not mine & storages(state)
        assert not mine & buffers
        kept.append(((new_state, out), graphs.owned((new_state, out))))
        state = new_state
    for result, copy in kept:
        for a, b in zip(leaves(result), leaves(copy)):
            assert torch.equal(a, b)


def test_graph_key_separates_shapes_devices_and_threads(replayed_on_cpu):
    def double(x, scale):
        return x * scale

    c0, r0 = graphs.capture_count(), graphs.replay_count()
    a = graphs.run(double, torch.ones(3), 2.0)
    b = graphs.run(double, torch.ones(4), 2.0)
    assert graphs.capture_count() - c0 == 2
    graphs.run(double, torch.full((3,), 5.0), 2.0)
    assert graphs.capture_count() - c0 == 2
    assert graphs.replay_count() - r0 == 3
    # the replay wrote the buffers the first call returned
    assert torch.equal(a, torch.full((3,), 10.0)) and b.shape == (4,)
    # a constant of the key is part of it
    graphs.run(double, torch.ones(3), 3.0)
    assert graphs.capture_count() - c0 == 3
    assert len(replayed_on_cpu) == 3

    # another thread keeps entries of its own
    seen = []
    worker = threading.Thread(target=lambda: seen.append(
        (graphs.run(double, torch.ones(3), 2.0), len(graphs._entries()))))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and seen[0][1] == 1
    assert graphs.capture_count() - c0 == 4
    assert len(replayed_on_cpu) == 3

    # the device is part of the key
    ones = [torch.ones(3)]
    spec = graphs._flatten((ones[0], 2.0), [])
    assert (graphs._key(double, spec, ones)
            != graphs._key(double, spec, [torch.ones(3, device="meta")]))


def test_cpu_tensors_never_capture():
    def double(x):
        return x * 2.0

    c0, r0 = graphs.capture_count(), graphs.replay_count()
    n = len(graphs._entries())
    x = torch.arange(4.0)
    y = graphs.run(double, x)
    z = graphs.run(double, x)
    assert torch.equal(y, x * 2.0) and y is not z
    assert (graphs.capture_count(), graphs.replay_count()) == (c0, r0)
    assert len(graphs._entries()) == n


def test_counts_and_constants_hold_under_threads(replayed_on_cpu):
    """Eight threads capture and replay at once, switching often: the
    counts are exact, and every thread reads the one cached constant."""
    def shift(x):
        return x + graphs.constant((1.0, 2.0, 3.0), torch.float32, x.device)

    c0, r0 = graphs.capture_count(), graphs.replay_count()
    results = []

    def work():
        for _ in range(50):
            results.append(graphs.run(shift, torch.zeros(3)).clone())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert graphs.capture_count() - c0 == 8
    assert graphs.replay_count() - r0 == 400
    assert len(results) == 400
    assert all(torch.equal(r, torch.tensor([1.0, 2.0, 3.0])) for r in results)

"""PyTorch port vs JAX package: the building blocks of the loop-closure path
— the submap grid (``graph/submap_grid.py``) and ICP (``loop/icp.py``).
Detection and a whole loop-on mapping cycle are in
``test_torch_loop_cycle.py``.

Inputs are made from a seed with NumPy and go through both sides.
Tolerances, stated at each assert: hash slots, counts, tags and masks
exact; coordinate sums 1e-5 (float32 scatter-adds in another order); ICP
pose 1e-4 and fitness 1e-4 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.graph import keyframes as jkf
from lego_loam_tpu.graph import submap_grid as jgrid
from lego_loam_tpu.loop.icp import icp_align as jicp
from lego_loam_tpu_torch.graph import keyframes as tkf
from lego_loam_tpu_torch.graph import submap_grid as tgrid
from lego_loam_tpu_torch.loop import icp as ticp
from torch_port_util import small_cfgs, tnp, to_np, to_torch

# loop closure on; a closure needs 4 s of age (the lap below takes ~8.6 s)
# and every accepted closure re-solves (negative relinearisation threshold)
JCFG, TCFG = small_cfgs(mapping=dict(
    enable_loop_closure=True, loop_closure_time_gap=4.0,
    loop_relin_trans=-1.0, max_keyframes=32, max_loop_factors=16,
    max_map_corner=2048, max_map_surf=4096, loop_history_cap=8192,
    loop_source_cap=512, surrounding_keyframe_search_num=8))
WINDOW = JCFG.mapping.surrounding_keyframe_search_num


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# submap grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("leaf,n_slots,scale,offset", [
    (0.2, 2048, 30.0, 0.0),        # ±30 m: every product wraps in int32
    (0.4, 4096, 5.0, -400.0),      # all negative, far from the origin
    (0.2, 8192, 2000.0, 0.0),      # |q| ~ 10^4: large coordinates
])
def test_grid_slots_match_jax_bit_for_bit(leaf, n_slots, scale, offset):
    """Against the JAX function compiled, as ``insert``/``rebuild`` run it
    (compiled, it divides by ``leaf`` as a multiplication)."""
    rng = np.random.default_rng(0)
    xyz = (rng.uniform(-scale, scale, (5000, 3)) + offset).astype(np.float32)
    valid = rng.random(5000) > 0.2
    ref = np.asarray(jax.jit(jgrid._slots, static_argnums=(2, 3))(
        jnp.asarray(xyz), jnp.asarray(valid), leaf, n_slots))
    got = tnp(tgrid._slots(_t(xyz), _t(valid), leaf, n_slots))
    np.testing.assert_array_equal(got, ref)                 # exact
    assert (got[~valid] == n_slots).all()


def _keyframe_clouds(rng, n):
    """``n`` random keyframe payloads (sensor frame) and poses: points in a
    12 m box so that neighbouring keyframes share voxels."""
    out = []
    for k in range(n):
        pose = np.concatenate([rng.normal(0, 0.05, 3),
                               [0.3 * k, 0.1 * k, 0.0]]).astype(np.float32)
        row = {"pose": pose}
        for name, cap in (("corner", tkf.CORNER_CAP), ("surf", tkf.SURF_CAP),
                          ("outlier", tkf.OUTLIER_CAP)):
            row[name] = rng.uniform(-6, 6, (cap, 3)).astype(np.float32)
            row[name + "_valid"] = rng.random(cap) > 0.3
        out.append(row)
    return out


_ARGS = ("corner", "corner_valid", "surf", "surf_valid", "outlier",
         "outlier_valid")


def _assert_grids_equal(got, ref, sum_atol=1e-5):
    ref = to_np(ref)
    for name in ("corner_cnt", "corner_tag", "surf_cnt", "surf_tag"):
        np.testing.assert_array_equal(tnp(getattr(got, name)),
                                      getattr(ref, name), err_msg=name)
    for name in ("corner_sum", "surf_sum"):
        np.testing.assert_allclose(tnp(getattr(got, name)),
                                   getattr(ref, name), atol=sum_atol,
                                   err_msg=name)


def test_grid_insert_and_maps_match_jax():
    """Twelve keyframes through ``insert`` with a window of 4, so slots go
    stale and restart; after each insert the grid and its live submap view
    agree.  A disabled insert leaves the grid as it was."""
    rng = np.random.default_rng(1)
    jg, tg = jgrid.empty_grid(JCFG), tgrid.empty_grid(TCFG, "cpu")
    window = 4
    for k, row in enumerate(_keyframe_clouds(rng, 12)):
        jg = jgrid.insert(jg, jnp.int32(k), jnp.asarray(row["pose"]),
                          *(jnp.asarray(row[a]) for a in _ARGS),
                          cfg=JCFG, window=window)
        tg = tgrid.insert(tg, torch.tensor(k, dtype=torch.int32),
                          _t(row["pose"]), *(_t(row[a]) for a in _ARGS),
                          TCFG, window)
        _assert_grids_equal(tg, jg)
    for jm, tm in zip(jgrid.maps(jg, jnp.int32(12), window),
                      tgrid.maps(tg, torch.tensor(12, dtype=torch.int32),
                                 window)):
        np.testing.assert_array_equal(tnp(tm.valid), np.asarray(jm.valid))
        np.testing.assert_allclose(tnp(tm.xyz), np.asarray(jm.xyz),
                                   atol=1e-5)
    assert tnp(tm.valid).sum() > 100
    same = tgrid.insert(tg, torch.tensor(12, dtype=torch.int32),
                        _t(row["pose"]), *(_t(row[a]) for a in _ARGS),
                        TCFG, window, enable=torch.tensor(False))
    for f in dataclasses.fields(tg):
        assert torch.equal(getattr(same, f.name), getattr(tg, f.name))


def test_grid_rebuild_matches_jax():
    """``rebuild`` of 20 keyframes with a window of 8: counts exact, sums
    1e-5, tags = the newest writer of each slot (exact, against a NumPy
    oracle).  The JAX package's CPU scatter keeps the LAST write instead,
    and it writes all surf blocks before all outlier blocks; its tags equal
    the port's on every slot except those where an older keyframe's outlier
    point followed a newer keyframe's surf point, and there it holds the
    older keyframe."""
    rng = np.random.default_rng(2)
    rows = _keyframe_clouds(rng, 20)
    store = jkf.empty_store(JCFG)
    for k, row in enumerate(rows):
        store = jkf.insert_keyframe(
            store, jnp.asarray(row["pose"]), jnp.float32(0.5 * k),
            *(jnp.asarray(row[a]) for a in _ARGS),
            jnp.zeros((tkf.SCAN2D_CAP, 3)), jnp.zeros((tkf.SCAN2D_CAP,), bool))
    count = jnp.int32(20)
    ref = to_np(jgrid.rebuild(store.pose, count, store.clouds, cfg=JCFG,
                              window=WINDOW))
    got = tgrid.rebuild(_t(store.pose), torch.tensor(20, dtype=torch.int32),
                        to_torch("KeyframeClouds", store.clouds), TCFG,
                        WINDOW)
    for name in ("corner_cnt", "surf_cnt"):
        np.testing.assert_array_equal(tnp(getattr(got, name)),
                                      getattr(ref, name))
    for name in ("corner_sum", "surf_sum"):
        np.testing.assert_allclose(tnp(getattr(got, name)),
                                   getattr(ref, name), atol=1e-5)
    np.testing.assert_array_equal(tnp(got.corner_tag), ref.corner_tag)

    # surf grid: NumPy oracles of both write rules, in the JAX write order
    m = JCFG.mapping
    poses = np.asarray(store.pose)
    slots, tags = [], []
    for block, cap in (("surf", tkf.SURF_CAP), ("outlier", tkf.OUTLIER_CAP)):
        for k in range(20 - WINDOW, 20):
            pts = np.asarray(jse3.apply(jnp.asarray(poses[k]),
                                        jnp.asarray(rows[k][block])))
            s = np.asarray(jgrid._slots(jnp.asarray(pts),
                                        jnp.asarray(rows[k][block + "_valid"]),
                                        m.surf_leaf_size, m.max_map_surf))
            slots.append(s)
            tags.append(np.full(cap, k, np.int32))
    slots, tags = np.concatenate(slots), np.concatenate(tags)
    ok = slots < m.max_map_surf
    newest = np.full(m.max_map_surf, -1, np.int32)
    np.maximum.at(newest, slots[ok], tags[ok])
    last = np.full(m.max_map_surf, -1, np.int32)
    last[slots[ok]] = tags[ok]                       # sequential: last wins
    np.testing.assert_array_equal(tnp(got.surf_tag), newest)
    np.testing.assert_array_equal(ref.surf_tag, last)
    differ = newest != last
    assert (last[differ] < newest[differ]).all()
    np.testing.assert_array_equal(tnp(got.surf_tag)[~differ],
                                  ref.surf_tag[~differ])


# --------------------------------------------------------------------------
# ICP, on the cases of tests/test_loop.py
# --------------------------------------------------------------------------

def _pad(pts, cap=2048):
    out = np.zeros((cap, 3), np.float32)
    v = np.zeros((cap,), bool)
    n = min(len(pts), cap)
    out[:n] = pts[:n]
    v[:n] = True
    return out, v


def _icp_cases():
    m = JCFG.mapping
    full = dict(max_iters=m.icp_max_iters, max_corr_dist=m.icp_max_corr_dist,
                eps=m.icp_eps)
    rng = np.random.default_rng(0)
    a = rng.uniform(-5, 5, (800, 3)).astype(np.float32)
    a[:300, 2] = 0.0
    a[300:500, 0] = 4.0
    a[500:700, 1] = -3.0
    true_pose = jnp.asarray([0.02, -0.03, 0.15, 0.4, -0.3, 0.2], jnp.float32)
    b = np.asarray(jse3.apply(true_pose, jnp.asarray(a)))
    yield "recovers_transform", a, b, dict(max_iters=16)

    rng = np.random.default_rng(1)
    yield ("unrelated", rng.uniform(-5, 5, (500, 3)).astype(np.float32),
           rng.uniform(40, 60, (500, 3)).astype(np.float32),
           dict(max_iters=16))

    rng = np.random.default_rng(4)
    tgt = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    tgt[:800, 2] = 0.0
    tgt[800:1400, 0] = 4.0
    src = rng.uniform(200, 210, (600, 3)).astype(np.float32)
    src[:40] = tgt[:40]
    yield "low_overlap", src, tgt, full

    rng = np.random.default_rng(8)
    ang = np.repeat(np.arange(12) * np.pi / 6, 120)
    pillar = np.stack([8 * np.cos(ang), 8 * np.sin(ang),
                       np.tile(np.linspace(0, 3, 120), 12)], 1)
    pillar += rng.normal(0, 0.01, pillar.shape)
    tgt = pillar.astype(np.float32)
    c, s = np.cos(np.deg2rad(10)), np.sin(np.deg2rad(10))
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    yield "pillar_ring", (tgt @ R.T).astype(np.float32), tgt, full


@pytest.mark.parametrize("case", list(_icp_cases()), ids=lambda c: c[0])
def test_icp_matches_jax(case):
    """Pose within 1e-4, fitness within 1e-4 relative, correspondences
    exact; the iterations counted on the host.  Two unrelated clouds have
    no alignment to agree on (each iteration amplifies the last bits of the
    one before): there both sides must only fail the fitness gate."""
    name, a, b, kw = case
    src, src_v = _pad(a)
    tgt, tgt_v = _pad(b)
    rp, rf, rn = jicp(jnp.asarray(src), jnp.asarray(src_v), jnp.asarray(tgt),
                      jnp.asarray(tgt_v), **kw)
    before = ticp.iteration_count
    gp, gf, gn = ticp.icp_align(_t(src), _t(src_v), _t(tgt), _t(tgt_v), **kw)
    assert 1 <= ticp.iteration_count - before <= kw["max_iters"]
    if name == "unrelated":
        gate = JCFG.mapping.history_keyframe_fitness_score
        assert float(gf) > gate and float(rf) > gate
        return
    np.testing.assert_allclose(tnp(gp), np.asarray(rp), atol=1e-4)
    np.testing.assert_allclose(float(gf), float(rf), rtol=1e-4, atol=1e-7)
    assert float(gn) == float(rn)

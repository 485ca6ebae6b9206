"""PyTorch port vs JAX package: lock-step multi-stream replay on the CPU.

Two distinct streams of ten scans (two mapping cycles each) go through
``batched_replay`` on both sides from the same packed arrays.  Against the
JAX package the comparison is by trajectory, as for the single-stream
replay (``tests/test_torch_slam.py``): nearest-neighbour tie-breaks and
another summation order allow 0.01 rad / 0.05 m on the poses, while the
integer counters are equal.  Against the port's own single-stream
``replay`` each stream is bit-equal: the batched stage 1 labels all images
at once and reduces nothing over the batch axis.

The map caps and iteration counts are cut below ``small_cfgs`` to keep the
JAX side's batched compile and run (the slow half) short."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lego_loam_tpu.io.npz_io import pack_sequence as jpack_sequence
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.frontend import cuda_label
from lego_loam_tpu_torch.frontend import segmentation as tseg
from lego_loam_tpu_torch.io.npz_io import pack_raw_scan, pack_sequence
from lego_loam_tpu_torch.pipeline import slam as tslam
from torch_port_util import small_cfgs, tnp, to_np

JCFG, TCFG = small_cfgs(
    feature=dict(odom_surf_iters=3, odom_corner_iters=3, max_less_sharp=256,
                 max_less_flat=1024),
    mapping=dict(max_map_corner=1024, max_map_surf=2048, max_keyframes=16,
                 scan2map_iters=2, surrounding_keyframe_search_num=4),
    pipeline=dict(max_points=6144, max_outlier=512))
B, N = 2, 10          # mapping at scans 4 and 9: two cycles a stream
POSES = ("odom", "fused", "mapped")


@pytest.fixture(scope="module")
def sequences():
    return [make_sequence(N, JCFG, seed=42 + b, noise=0.01, speed=1.2,
                          radius=6.0) for b in range(B)]


@pytest.fixture(scope="module")
def packed(sequences):
    per = [pack_sequence(s, t, TCFG, device="cpu") for s, _, t in sequences]
    return per, tuple(torch.stack([p[k] for p in per]) for k in range(3))


@pytest.fixture(scope="module")
def torch_batched(packed):
    return tslam.batched_replay(*packed[1], TCFG, device="cpu")


@pytest.fixture(scope="module")
def jax_batched(sequences):
    jp = [jpack_sequence(s, t, JCFG) for s, _, t in sequences]
    args = [jnp.stack([p[k] for p in jp]) for k in range(3)]
    state, outs = jslam.batched_replay(*args, JCFG)
    return to_np(state), to_np(outs), jp


def test_batched_replay_matches_jax(packed, torch_batched, jax_batched):
    per, (x, v, t) = packed
    jstate, jouts, jp = jax_batched
    for b in range(B):
        np.testing.assert_array_equal(tnp(x[b]), np.asarray(jp[b][0]))
        np.testing.assert_array_equal(tnp(v[b]), np.asarray(jp[b][1]))
    states, outs = torch_batched
    assert len(states) == B
    for name in POSES:
        got, ref = tnp(outs[name]), jouts[name]
        assert got.shape == ref.shape == (B, N, 6)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=0.01,
                                   err_msg=name)
        np.testing.assert_allclose(got[..., 3:], ref[..., 3:], atol=0.05,
                                   err_msg=name)
    jmeta = jstate.mapping.meta
    for b, st in enumerate(states):
        meta = st.mapping.meta
        assert st.scan_index == int(jstate.scan_index[b]) == N
        assert int(meta.kf_count) == int(jmeta.kf_count[b]) == 2
        assert int(meta.factor_count) == int(jmeta.factor_count[b]) == 1
        assert int(meta.cycle) == int(jmeta.cycle[b]) == 2
        for name in ("kf_dropped", "factor_dropped", "map_sat"):
            assert int(getattr(meta, name)) == \
                int(getattr(jmeta, name)[b]) == 0
    # the streams differ, and the second cycle matched against the first
    assert np.abs(jouts["fused"][0] - jouts["fused"][1]).max() > 0.1
    assert np.abs(jouts["mapped"][:, -1] - jouts["odom"][:, 9]).max() > 0


def test_each_stream_equals_its_own_replay(packed, torch_batched):
    per, _ = packed
    states, outs = torch_batched
    assert set(outs) == {"odom", "fused", "mapped", "kf_count",
                         "factor_count", "loop_diag"}
    for b in range(B):
        state, ref = tslam.replay(*per[b], TCFG, device="cpu")
        for name in ref:
            assert torch.equal(outs[name][b], ref[name]), (b, name)
        got_tree = convert.to_numpy_tree(states[b])
        ref_tree = convert.to_numpy_tree(state)

        def walk(a, r, path=""):
            if isinstance(r, dict):
                for k in r:
                    walk(a[k], r[k], f"{path}.{k}")
            else:
                np.testing.assert_array_equal(a, r, err_msg=path)
        walk(got_tree, ref_tree)


def test_final_states_split_from_jax(packed, torch_batched, jax_batched):
    """``convert.split_batched`` takes the JAX package's batched final state
    apart into B port states: every leaf is the stream's slice, and each
    agrees with the port's own final state of that stream."""
    jstate, _, _ = jax_batched
    states, _ = torch_batched
    split = convert.split_batched("SlamState", jstate, device="cpu")
    assert len(split) == B
    for b, (js, st) in enumerate(zip(split, states)):
        assert isinstance(js, tslam.SlamState)
        assert js.scan_index == st.scan_index == N
        np.testing.assert_array_equal(tnp(js.mapping.meta.kf_pose),
                                      jstate.mapping.meta.kf_pose[b])
        np.testing.assert_array_equal(tnp(js.mapping.clouds.surf),
                                      jstate.mapping.clouds.surf[b])
        np.testing.assert_array_equal(tnp(js.odo.last_surf.valid),
                                      jstate.odo.last_surf.valid[b])
        for name in ("kf_count", "factor_count", "cycle"):
            assert int(getattr(js.mapping.meta, name)) == \
                int(getattr(st.mapping.meta, name))
        kf = int(st.mapping.meta.kf_count)
        got = tnp(st.mapping.meta.kf_pose[:kf])
        ref = tnp(js.mapping.meta.kf_pose[:kf])
        np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=0.01)
        np.testing.assert_allclose(got[:, 3:], ref[:, 3:], atol=0.05)
    # a split state resumes like any state
    x, v, t = packed[0][0]
    resumed, outs = tslam.replay_from(split[0], x[:2], v[:2], t[:2], TCFG,
                                      device="cpu")
    assert resumed.scan_index == N + 2
    assert torch.isfinite(outs["fused"]).all()


def _image(V, H, seg_rows):
    seg = torch.zeros((V, H), dtype=torch.bool)
    for i, cols in seg_rows:
        seg[i, cols] = True
    return seg


def _label_case(seg, right=None, down=None):
    """Kernel inputs from masks; edges only join segmentable pixels."""
    V, H = seg.shape
    right = torch.ones_like(seg) if right is None else right
    down = torch.ones_like(seg) if down is None else down
    right = right & seg & torch.roll(seg, -1, dims=1)
    down = down.clone()
    down[:-1] &= seg[:-1] & seg[1:]
    down[-1] = False
    flat = torch.arange(V * H, dtype=torch.int32).reshape(V, H)
    return torch.where(seg, flat, cuda_label.SENTINEL), right, down


def _label_cases(V=16, H=360):
    gen = torch.Generator().manual_seed(3)
    rnd = lambda p: torch.rand((V, H), generator=gen) < p  # noqa: E731
    wrap = _image(V, H, [(4, slice(H - 6, H)), (4, slice(0, 5)),
                         (9, slice(100, 140))])
    serp = torch.zeros((V, H), dtype=torch.bool)
    for i in range(0, V, 2):
        serp[i, 20:H - 20] = True
    for i in range(1, V - 1, 2):
        serp[i, H - 21 if i % 4 == 1 else 20] = True
    full = torch.ones((V, H), dtype=torch.bool)
    only_wrap = torch.zeros((V, H), dtype=torch.bool)
    only_wrap[:, H - 1] = True
    only_wrap[:, :H // 2] = True
    only_wrap[:, H // 2 + 1:] = True
    down_wrap = torch.zeros((V, H), dtype=torch.bool)
    down_wrap[:, H - 1] = True
    edge = _image(V, H, [(0, slice(0, H)), (V - 1, slice(0, H)),
                         (V - 2, slice(H - 1, H))])
    return {
        "random": _label_case(rnd(0.8), rnd(0.45), rnd(0.45)),
        "wrap": _label_case(wrap),
        "serpentine": _label_case(serp),
        "empty": _label_case(torch.zeros((V, H), dtype=torch.bool)),
        "all_one_through_wrap": _label_case(full, only_wrap, down_wrap),
        "first_and_last_rows": _label_case(edge),
    }


@pytest.mark.parametrize("edges", ["bool", "int32"])
def test_batched_plain_labels_equal_single_calls(edges):
    """The plain version on (B, V, H) gives each image what a call of its
    own gives, also when the images need different numbers of sweeps (the
    serpentine one the most) and when the sweep cap stops them."""
    cases = _label_cases()
    names = list(cases)
    stacked = [torch.stack([cases[n][k] for n in names]) for k in range(3)]
    if edges == "int32":
        stacked[1:] = [e.to(torch.int32) for e in stacked[1:]]
    for cap in (64, 2):
        batched = cuda_label.propagate_labels_torch(*stacked, max_sweeps=cap)
        assert batched.shape == (len(names), 16, 360)
        for k, name in enumerate(names):
            single = cuda_label.propagate_labels_torch(
                stacked[0][k], stacked[1][k], stacked[2][k], max_sweeps=cap)
            assert torch.equal(batched[k], single), (cap, name)
    full = cuda_label.propagate_labels(*stacked)
    H = 360
    seg = stacked[0] != cuda_label.SENTINEL
    assert set(full[1, 4, H - 6:].tolist() + full[1, 4, :5].tolist()) \
        == {4 * H}
    assert (full[2][seg[2]] == 20).all()
    assert (full[3] == cuda_label.SENTINEL).all()
    assert (full[4] == 0).all()
    # the serpentine image has not converged after 2 sweeps
    capped = cuda_label.propagate_labels_torch(*stacked, max_sweeps=2)
    assert not torch.equal(capped[2], full[2])


def test_batched_label_wrapper_dispatch():
    """(B, V, H) CPU tensors take the plain version and launch nothing; the
    kernel wrapper takes (B, V, H) and refuses other ranks."""
    lab0 = torch.full((3, 4, 8), cuda_label.SENTINEL, dtype=torch.int32)
    z = torch.zeros((3, 4, 8), dtype=torch.bool)
    before = cuda_label.launch_count
    out = cuda_label.propagate_labels(lab0, z, z)
    assert cuda_label.launch_count == before
    assert out.shape == (3, 4, 8) and (out == cuda_label.SENTINEL).all()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_label.propagate_labels_cuda(lab0, z, z)      # not on the card
    with pytest.raises(ValueError, match="B, V, H"):
        cuda_label.propagate_labels_cuda(lab0[None], z[None], z[None])


def test_image_projection_batched_equals_single(sequences):
    """Stage 1 of B scans at once: every ``ProjectionOut`` bit-equal to
    ``image_projection`` of its scan alone."""
    raws = [pack_raw_scan(scans[3], float(times[3]),
                          TCFG.pipeline.max_points, device="cpu")
            for scans, _, times in sequences]
    batched = tseg.image_projection_batched(raws, TCFG)
    assert len(batched) == B
    for raw, got in zip(raws, batched):
        ref = convert.to_numpy_tree(tseg.image_projection(raw, TCFG))
        got = convert.to_numpy_tree(got)
        for key in ("outlier_xyz", "outlier_valid", "scan2d_xyz",
                    "scan2d_valid", "stamp"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        for key, val in ref["segmented"].items():
            np.testing.assert_array_equal(got["segmented"][key], val,
                                          err_msg=key)
    assert int(tnp(batched[0].segmented.count).sum()) > 1000


def test_batched_replay_needs_a_cuda_device_unless_told(packed):
    if torch.cuda.is_available():            # decided inside the test
        pytest.skip("a CUDA device is present")
    _, (x, v, t) = packed
    with pytest.raises(RuntimeError, match="CUDA"):
        tslam.batched_replay(x, v, t, TCFG)
    with pytest.raises(ValueError, match="B, N"):
        tslam.batched_replay(x[0], v[0], t[0], TCFG, device="cpu")

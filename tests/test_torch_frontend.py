"""PyTorch port vs JAX package, stage 1 + feature extraction, on the CPU.

Each stage gets the JAX output of the stage before it on BOTH sides.
Integers (pixel winners, labels, columns, pick layouts) must be
bit-identical; floats agree to 1e-6 (same float32 formulas, libm-level
differences only)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lego_loam_tpu.core.types import RangeImage as JRangeImage
from lego_loam_tpu.frontend import features as jfeat
from lego_loam_tpu.frontend import projection as jproj
from lego_loam_tpu.frontend import segmentation as jseg
from lego_loam_tpu.io.npz_io import pack_raw_scan as jpack
from lego_loam_tpu.io.synthetic import make_sequence
from lego_loam_tpu_torch.frontend import cuda_label
from lego_loam_tpu_torch.frontend import features as tfeat
from lego_loam_tpu_torch.frontend import projection as tproj
from lego_loam_tpu_torch.frontend import segmentation as tseg
from torch_port_util import small_cfgs, tnp, to_np, to_torch

JCFG, TCFG = small_cfgs()
SEEDS = (3, 11)
# the JAX flood outside jit dispatches op by op; compile it once instead
J_LABEL = jax.jit(jseg.label_components, static_argnames="cfg")


@pytest.fixture(scope="module")
def raws():
    out = []
    for seed in SEEDS:
        scans, _, times = make_sequence(2, JCFG, seed=seed, noise=0.01)
        out.append(jpack(scans[1], float(times[1]), JCFG.pipeline.max_points))
    return out


@pytest.fixture(scope="module")
def images(raws):
    return [jproj.project_scan(r, JCFG) for r in raws]


@pytest.fixture(scope="module")
def projections(images, raws):
    return [jseg.segment_cloud(i, r.stamp, JCFG)
            for i, r in zip(images, raws)]


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_project_scan_matches_jax(raws, images, k):
    ref = to_np(images[k])
    got = tproj.project_scan(to_torch("RawScan", raws[k]), TCFG)
    assert ref.valid.sum() > 1000
    np.testing.assert_array_equal(tnp(got.valid), ref.valid)
    np.testing.assert_array_equal(tnp(got.ground), ref.ground)
    # identical winners ⇒ identical points (copied, not recomputed)
    np.testing.assert_array_equal(tnp(got.xyz), ref.xyz)
    np.testing.assert_allclose(tnp(got.rng), ref.rng, rtol=1e-6)
    np.testing.assert_allclose(tnp(got.start_orientation),
                               ref.start_orientation, atol=1e-6)
    np.testing.assert_allclose(tnp(got.end_orientation),
                               ref.end_orientation, atol=1e-6)
    xyz2d, ok2d = tproj.virtual_scan_2d(to_torch("RangeImage", images[k]),
                                        TCFG)
    jxyz, jok = jproj.virtual_scan_2d(images[k], JCFG)
    np.testing.assert_array_equal(tnp(ok2d), np.asarray(jok))
    np.testing.assert_array_equal(tnp(xyz2d), np.asarray(jxyz))


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_label_components_matches_jax(images, k):
    jl, jsegm = J_LABEL(images[k], JCFG)
    tl, tsegm = tseg.label_components(to_torch("RangeImage", images[k]), TCFG)
    np.testing.assert_array_equal(tnp(tsegm), np.asarray(jsegm))
    np.testing.assert_array_equal(tnp(tl), np.asarray(jl))
    assert len(np.unique(np.asarray(jl))) > 5


def _image_from_masks(segmentable, rng):
    """A RangeImage whose merge edges are exactly 4-adjacency between
    segmentable pixels of equal range (equal ranges give tan β ≫ tan θ;
    a 30× range ratio never merges)."""
    V, H = segmentable.shape
    z = np.zeros((V, H), np.float32)
    return JRangeImage(
        rng=jnp.asarray(rng, jnp.float32),
        xyz=jnp.zeros((V, H, 3), jnp.float32),
        valid=jnp.asarray(segmentable), ground=jnp.zeros((V, H), bool),
        label=jnp.full((V, H), -1, jnp.int32),
        start_orientation=jnp.float32(0.0),
        end_orientation=jnp.float32(2 * np.pi))


def _wrap_case():
    V, H = JCFG.laser.image_size
    seg = np.zeros((V, H), bool)
    seg[4, H - 6:] = True
    seg[4, :5] = True                 # one component across the wrap column
    seg[9, 100:140] = True            # a second one elsewhere
    return seg, np.full((V, H), 10.0, np.float32)


def _serpentine_case():
    """Full rows on even rings joined by single connector pixels at
    alternating ends on the odd rings: ONE component whose minimum label
    has to travel down every row in turn (many flood sweeps)."""
    V, H = JCFG.laser.image_size
    seg = np.zeros((V, H), bool)
    for i in range(0, V, 2):
        seg[i, 20:200] = True
    for i in range(1, V - 1, 2):
        seg[i, 199 if i % 4 == 1 else 20] = True
    return seg, np.full((V, H), 10.0, np.float32)


def _empty_case():
    V, H = JCFG.laser.image_size
    return np.zeros((V, H), bool), np.full((V, H), 10.0, np.float32)


@pytest.mark.parametrize("case", [_wrap_case, _serpentine_case, _empty_case],
                         ids=["wrap", "serpentine", "empty"])
def test_label_components_hand_made_masks(case):
    seg, rng = case()
    img = _image_from_masks(seg, rng)
    jl, _ = J_LABEL(img, JCFG)
    tl, _ = tseg.label_components(to_torch("RangeImage", img), TCFG)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tnp(tl), jl)
    H = seg.shape[1]
    if case is _wrap_case:
        comp = jl[4, H - 6:].tolist() + jl[4, :5].tolist()
        assert set(comp) == {4 * H}          # min flat index, both sides
        assert jl[9, 120] == 9 * H + 100
    if case is _serpentine_case:
        assert (jl[seg] == 20).all()         # one component, min index
        assert (jl[~seg] == cuda_label.SENTINEL).all()
    if case is _empty_case:
        assert (jl == cuda_label.SENTINEL).all()


def test_propagate_labels_wrapper_dispatch():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrapper refuses what it cannot take instead of falling back."""
    lab0 = torch.full((4, 8), cuda_label.SENTINEL, dtype=torch.int32)
    z = torch.zeros((4, 8), dtype=torch.int32)
    before = cuda_label.launch_count
    out = cuda_label.propagate_labels(lab0, z, z)
    assert cuda_label.launch_count == before
    assert (out == cuda_label.SENTINEL).all()
    with pytest.raises(ValueError):
        cuda_label.propagate_labels_cuda(lab0, z, z)      # not on the card


def _edges_of(seg, rng_img):
    img = to_torch("RangeImage", _image_from_masks(seg, rng_img))
    segmentable, right, down = tseg._edge_masks(img, TCFG)
    V, H = seg.shape
    flat = torch.arange(V * H, dtype=torch.int32).reshape(V, H)
    return torch.where(segmentable, flat, cuda_label.SENTINEL), right, down


@pytest.mark.parametrize("case", [_wrap_case, _serpentine_case, _empty_case],
                         ids=["wrap", "serpentine", "empty"])
def test_propagate_labels_bool_and_int32_edges(case):
    """Edge images as the pipeline makes them (bool) and as the JAX
    package passes them (int32 0/1) give the same labels, through the
    dispatcher and through the plain version."""
    lab0, right, down = _edges_of(*case())
    assert right.dtype == torch.bool and down.dtype == torch.bool
    as_bool = cuda_label.propagate_labels(lab0, right, down)
    as_int = cuda_label.propagate_labels(lab0, right.to(torch.int32),
                                         down.to(torch.int32))
    plain = cuda_label.propagate_labels_torch(lab0, right, down)
    assert as_bool.dtype == torch.int32
    assert torch.equal(as_bool, as_int) and torch.equal(as_bool, plain)


def test_propagate_labels_cuda_refuses_mixed_edges():
    lab0 = torch.full((4, 8), cuda_label.SENTINEL, dtype=torch.int32)
    b = torch.zeros((4, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        cuda_label.propagate_labels_cuda(lab0, b, b.to(torch.int32))
    with pytest.raises(TypeError):
        cuda_label.propagate_labels_cuda(lab0.to(torch.int64), b, b)
    with pytest.raises(ValueError):
        cuda_label.propagate_labels_cuda(lab0, b, b)      # not on the card


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_segment_cloud_matches_jax(images, raws, projections, k):
    ref = to_np(projections[k])
    got = tseg.segment_cloud(to_torch("RangeImage", images[k]),
                             torch.tensor(float(raws[k].stamp)), TCFG)
    s, r = got.segmented, ref.segmented
    assert r.count.sum() > 500
    np.testing.assert_array_equal(tnp(s.count), r.count)
    np.testing.assert_array_equal(tnp(s.col), r.col)
    np.testing.assert_array_equal(tnp(s.valid), r.valid)
    np.testing.assert_array_equal(tnp(s.is_ground), r.is_ground)
    np.testing.assert_allclose(tnp(s.xyz), r.xyz, atol=1e-6)
    np.testing.assert_allclose(tnp(s.rng), r.rng, rtol=1e-6)
    np.testing.assert_allclose(tnp(s.rel_time), r.rel_time, atol=1e-6)
    np.testing.assert_array_equal(tnp(got.outlier_valid), ref.outlier_valid)
    np.testing.assert_allclose(tnp(got.outlier_xyz), ref.outlier_xyz,
                               atol=1e-6)
    np.testing.assert_array_equal(tnp(got.scan2d_valid), ref.scan2d_valid)


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_extract_features_matches_jax(projections, k):
    seg = projections[k].segmented
    ref = to_np(jfeat.extract_features(seg, JCFG))
    got = tfeat.extract_features(to_torch("SegmentedCloud", seg), TCFG)
    assert ref.sharp.valid.sum() > 10 and ref.flat.valid.sum() > 10
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        g, r = getattr(got, name), getattr(ref, name)
        np.testing.assert_array_equal(tnp(g.valid), r.valid, err_msg=name)
        if name == "less_flat":       # voxel centroids: averaged rings
            np.testing.assert_allclose(tnp(g.ring), r.ring, atol=1e-5,
                                       err_msg=name)
        else:                         # picks: identical index sets + layout
            np.testing.assert_array_equal(tnp(g.ring), r.ring, err_msg=name)
        np.testing.assert_allclose(tnp(g.xyz), r.xyz, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(tnp(g.rel_time), r.rel_time, atol=1e-6,
                                   err_msg=name)


def test_argmin_argmax_return_first_extremum():
    """The pick loops and nearest-neighbour searches rely on ties going to
    the LOWER index, as ``jnp.argmin``/``argmax`` do."""
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0, 3.0], [5.0, 5.0, 5.0, 5.0, 5.0]])
    assert torch.argmin(x, dim=-1).tolist() == [1, 0]
    assert torch.argmax(x, dim=-1).tolist() == [3, 0]
    assert torch.min(x, dim=-1).indices.tolist() == [1, 0]
    big = torch.full((3, 4097), 3e38)
    assert torch.argmin(big, dim=-1).tolist() == [0, 0, 0]
    assert torch.min(big, dim=-1).indices.tolist() == [0, 0, 0]

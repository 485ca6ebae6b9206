"""PyTorch port vs JAX package: core math, the copied NumPy modules, the
state converter, and the rule that the port imports nothing of JAX."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.core import config as jconfig
from lego_loam_tpu.core import linalg3 as jl3
from lego_loam_tpu.core import se3 as jse3
from lego_loam_tpu.eval import metrics as jmetrics
from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu.pipeline import slam as jslam
from lego_loam_tpu_torch import convert
from lego_loam_tpu_torch.core import config as tconfig
from lego_loam_tpu_torch.core import linalg3 as tl3
from lego_loam_tpu_torch.core import se3 as tse3
from lego_loam_tpu_torch.eval import metrics as tmetrics
from lego_loam_tpu_torch.io import synthetic as tsyn
from lego_loam_tpu_torch.pipeline import slam as tslam
from torch_port_util import small_cfgs, tnp, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5      # same float32 formulas; only libm / summation order differ


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 1.0, (n, 6)).astype(np.float32)
    p[:, 3:] *= 20.0
    return p


@pytest.mark.parametrize("name", ["rpy_to_matrix", "pose_matrix", "inverse",
                                  "normalize_angles", "so3_exp"])
def test_se3_unary_matches_jax(name):
    p = _poses(64, 0)
    arg = p[:, :3] if name in ("rpy_to_matrix", "so3_exp") else p
    if name == "normalize_angles":
        arg = arg * 5.0
    ref = np.asarray(getattr(jse3, name)(jnp.asarray(arg)))
    got = tnp(getattr(tse3, name)(torch.from_numpy(arg)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("name", ["compose", "relative", "apply",
                                  "apply_inverse"])
def test_se3_binary_matches_jax(name):
    a, b = _poses(64, 1), _poses(64, 2)
    if name in ("apply", "apply_inverse"):
        b = b[:, 3:]
    ref = np.asarray(getattr(jse3, name)(jnp.asarray(a), jnp.asarray(b)))
    got = tnp(getattr(tse3, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, atol=ATOL * 20)   # 20 m lever arm
    # one pose applied to many points broadcasts the same way
    if name == "apply":
        ref1 = np.asarray(jse3.apply(jnp.asarray(a[0]), jnp.asarray(b)))
        got1 = tnp(tse3.apply(torch.from_numpy(a[0]), torch.from_numpy(b)))
        np.testing.assert_allclose(got1, ref1, atol=ATOL * 20)


def test_se3_roundtrips_and_log():
    p = _poses(32, 3)
    t = torch.from_numpy(p)
    np.testing.assert_allclose(
        tnp(tse3.matrix_to_rpy(tse3.rpy_to_matrix(t[:, :3]))), p[:, :3],
        atol=ATOL)
    np.testing.assert_allclose(
        tnp(tse3.matrix_to_pose(tse3.pose_matrix(t))), p, atol=ATOL)
    R = np.asarray(jse3.rpy_to_matrix(jnp.asarray(p[:, :3])))
    np.testing.assert_allclose(
        tnp(tse3.so3_log(torch.from_numpy(R))),
        np.asarray(jse3.so3_log(jnp.asarray(R))), atol=ATOL)
    np.testing.assert_allclose(
        tnp(tse3.skew(t[:, :3])), np.asarray(jse3.skew(jnp.asarray(p[:, :3]))))


def test_rpy_jacobian_matches_jacfwd():
    """The closed-form ∂R/∂rpy the solvers use equals forward-mode AD."""
    rpy = _poses(8, 4)[:, :3]
    ref = np.asarray(jax.vmap(jax.jacfwd(jse3.rpy_to_matrix))(
        jnp.asarray(rpy)))                        # (N, 3, 3, k)
    got = tnp(tse3.rpy_to_matrix_jac(torch.from_numpy(rpy)))   # (N, k, 3, 3)
    np.testing.assert_allclose(got, np.moveaxis(ref, -1, 1), atol=ATOL)


def test_linalg3_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((128, 3, 3)).astype(np.float32)
    b = rng.standard_normal((128, 3)).astype(np.float32)
    S = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tnp(tl3.solve3(torch.from_numpy(A), torch.from_numpy(b))),
        np.asarray(jl3.solve3(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-4, atol=1e-4)
    ev_j = np.asarray(jl3.eigvals_sym3(jnp.asarray(S)))
    ev_t = tl3.eigvals_sym3(torch.from_numpy(S))
    np.testing.assert_allclose(tnp(ev_t), ev_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ev_j, np.linalg.eigvalsh(S.astype(np.float64)),
                               rtol=1e-3, atol=1e-3)
    for col in (0, 2):
        v_j = np.asarray(jl3.principal_eigvec_sym3(
            jnp.asarray(S), jnp.asarray(ev_j[:, col])))
        v_t = tnp(tl3.principal_eigvec_sym3(
            torch.from_numpy(S), torch.from_numpy(ev_j[:, col])))
        np.testing.assert_allclose(v_t, v_j, atol=1e-3)
    d = rng.standard_normal((16, 40)).astype(np.float32)
    d[:, 7] = d[:, 3]                                   # a tie
    vj, ij = jl3.topk_small_min(jnp.asarray(d), 5)
    vt, it = tl3.topk_small_min(torch.from_numpy(d), 5)
    np.testing.assert_array_equal(tnp(it), np.asarray(ij))
    np.testing.assert_array_equal(tnp(vt), np.asarray(vj))


@pytest.mark.parametrize("name", ["vlp16", "hdl64"])
def test_config_copy_equals_original(name):
    """The port keeps its own copy of the config; it must not drift."""
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.laser.image_size == t.laser.image_size
    assert j.laser.ang_res_x == t.laser.ang_res_x
    assert j.laser.ang_res_y == t.laser.ang_res_y
    assert j.laser.ang_bottom == t.laser.ang_bottom


def test_numpy_copies_equal_originals():
    jc, tc = small_cfgs()
    js, jgt, jt = jsyn.make_sequence(2, jc, seed=5, noise=0.01, speed=1.2)
    ts, tgt, tt = tsyn.make_sequence(2, tc, seed=5, noise=0.01, speed=1.2)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jgt, tgt)
    np.testing.assert_array_equal(jt, tt)
    est, gt = _poses(30, 6), _poses(30, 7)
    for align in (True, False):
        assert jmetrics.ate(est, gt, align=align) == \
            tmetrics.ate(est, gt, align=align)
    assert jmetrics.rpe(est, gt, delta=5) == tmetrics.rpe(est, gt, delta=5)


def test_convert_roundtrip_of_a_jax_state():
    """A JAX SlamState goes through NumPy into the port and back with every
    leaf unchanged; the submap grid crosses too and equals the port's own
    empty grid (``scan_index`` is a host int in the port)."""
    jc, tc = small_cfgs()
    js = to_np(jslam.init_state(jc))
    ts = convert.from_numpy_tree("SlamState", js, device="cpu")
    fresh = convert.to_numpy_tree(tslam.init_state(tc, device="cpu"))
    back = convert.to_numpy_tree(ts)
    assert ts.scan_index == 0
    jgrid = js.mapping.meta.grid
    for name in ("corner_sum", "corner_cnt", "corner_tag", "surf_sum",
                 "surf_cnt", "surf_tag"):
        got = tnp(getattr(ts.mapping.meta.grid, name))
        ref = getattr(jgrid, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif a is None:
            assert b is None, path
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(back, fresh)                      # same layout as the port's own
    assert back["odo"]["last_surf"]["xyz"].shape == \
        js.odo.last_surf.xyz.shape
    assert back["mapping"]["clouds"]["surf"].shape == \
        js.mapping.clouds.surf.shape
    assert back["mapping"]["meta"]["graph"]["z"].shape == \
        js.mapping.meta.graph.z.shape


def test_entry_points_need_a_cuda_device_unless_told():
    from lego_loam_tpu_torch.core.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():          # decided inside the test
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            tslam.init_state(tconfig.vlp16())


def test_port_imports_no_jax():
    """Source scan: nothing under the port's package (Python, CUDA and host
    C++ sources), and not the chip script, imports JAX, flax or the JAX
    package (the chip script may only NAME files of it, in its
    ``replaces`` strings)."""
    banned = [re.compile(p) for p in
              (r"import\s+jax", r"from\s+jax", r"flax",
               r"lego_loam_tpu(?!_torch)")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    sources = (".py", ".cu", ".cuh", ".cpp", ".h", ".hpp")
    for root, _, names in os.walk(os.path.join(REPO, "lego_loam_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith(sources)]
    assert len(files) > 20
    assert any(f.endswith(".cpp") for f in files)
    for path in files:
        with open(path) as f:
            text = f.read()
        if path.endswith("chip_smoke.py"):
            # "replaces": "<JAX package>/<file>:<line>" names a file only
            text = re.sub(r'"lego_loam_tpu/[\w/]+\.py:\d+"', '""', text)
        for pat in banned:
            assert not pat.search(text), (path, pat.pattern)


def test_port_modules_share_no_private_names():
    """Source scan: no module of the port imports another's ``_private``
    name or reads one through a name it imported, and ``graph/`` imports
    nothing from ``distributed/`` (the keyframe store sits below the
    solvers and the mesh; it reaches a mesh's collectives through the mesh
    its blocks hold)."""
    import ast
    root = os.path.join(REPO, "lego_loam_tpu_torch")
    found = []
    for here, _, names in os.walk(root):
        for name in sorted(n for n in names if n.endswith(".py")):
            path = os.path.join(here, name)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            imported = set()
            for node in ast.walk(tree):
                if not isinstance(node, ast.ImportFrom) or not (
                        node.level or (node.module or "").startswith(
                            "lego_loam_tpu_torch")):
                    continue
                source = "." * node.level + (node.module or "")
                for alias in node.names:
                    if alias.name.startswith("_"):
                        found.append(f"{rel}: {alias.name} from {source}")
                    if rel.startswith("graph") and "distributed" in (
                            f"{source}.{alias.name}"):
                        found.append(f"{rel}: imports {source}.{alias.name}")
                    imported.add(alias.asname or alias.name)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in imported
                        and node.attr.startswith("_")
                        and not node.attr.startswith("__")):
                    found.append(f"{rel}: {node.value.id}.{node.attr}")
    assert not found, found

"""The port's host runtime: ``csrc/feeder.cpp`` built by ``hostlib.py`` with
the host compiler into ``build/``, and ``io/native_feeder.py`` on it — the
four cases of ``tests/test_native.py``, the packer held to the JAX
package's, the caller-buffer ``recv`` and :class:`DeviceFeed` on the CPU,
and the ``--streaming`` loop bit-equal to ``replay``."""

import os
import threading

import numpy as np
import pytest
import torch

from lego_loam_tpu.io import native_feeder as jnf
from lego_loam_tpu_torch import convert, hostlib, kernels
from lego_loam_tpu_torch import run as trun
from lego_loam_tpu_torch.io import native_feeder as tnf
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.io.synthetic import make_sequence
from lego_loam_tpu_torch.pipeline.slam import replay

from torch_port_util import small_cfgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_lib_builds_into_the_build_directory():
    path = hostlib.build()
    assert os.path.dirname(path) == os.path.abspath(kernels.build_dir())
    assert os.path.basename(path) == "libfeeder.so"
    assert os.path.samefile(os.path.dirname(path), os.path.join(REPO, "build"))
    assert hostlib.lib().lego_channel_create is not None
    assert hostlib.build() == path            # up to date: no rebuild


def test_pack_scan_matches_python_oracle_and_original():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    pts[::7] = np.nan
    pts[3, 0] = np.inf
    xyz, valid, n = tnf.pack_scan_native(pts, 600)
    finite = np.isfinite(pts).all(axis=-1)
    assert n == int(finite.sum())
    np.testing.assert_array_equal(valid[:500], finite)
    assert not valid[500:].any()
    np.testing.assert_array_equal(xyz[:500][finite], pts[finite])
    assert (xyz[:500][~finite] == 0).all()
    jxyz, jvalid, jn = jnf.pack_scan_native(pts, 600)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(valid, jvalid)
    assert n == jn


def test_pack_scan_capacity_clip():
    pts = np.ones((100, 3), np.float32)
    xyz, valid, n = tnf.pack_scan_native(pts, 40)
    assert n == 40 and valid[:40].all() and xyz.shape == (40, 3)


def test_channel_lockstep_roundtrip():
    ch = tnf.ScanChannel(capacity_points=128, depth=1)
    results = []

    def consumer():
        while True:
            item = ch.recv()
            if item is None:
                break
            results.append(item)

    th = threading.Thread(target=consumer)
    th.start()
    for i in range(5):
        pts = np.full((10, 3), float(i), np.float32)
        assert ch.send(pts, stamp=float(i))
    ch.close()
    th.join(timeout=5)
    assert not th.is_alive()
    assert not ch.send(np.zeros((1, 3), np.float32), 9.0)   # closed
    assert len(results) == 5
    for i, (xyz, valid, stamp) in enumerate(results):
        assert stamp == float(i)
        assert valid[:10].all() and not valid[10:].any()
        np.testing.assert_array_equal(xyz[:10].numpy(), float(i))


def test_recv_into_caller_buffers_and_device_feed_copies():
    C = 64
    ch = tnf.ScanChannel(capacity_points=C, depth=2)
    xyz = torch.full((C, 3), -1.0)
    valid = torch.ones((C,), dtype=torch.bool)
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    pts[4] = np.nan
    assert ch.send(pts, 1.25)
    got = ch.recv(xyz, valid)
    assert got[0] is xyz and got[1] is valid and got[2] == 1.25
    ref_xyz, ref_valid, _ = tnf.pack_scan_native(pts, C)
    np.testing.assert_array_equal(xyz.numpy(), ref_xyz)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    with pytest.raises(ValueError, match="contiguous CPU buffers"):
        ch.recv(torch.empty((C, 3), dtype=torch.float64), valid)
    # DeviceFeed: two buffers in turn, yet every scan it returns is its own
    feed = tnf.DeviceFeed(ch, torch.device("cpu"))
    scans = []
    for i in range(4):
        assert ch.send(np.full((5, 3), float(i), np.float32), 0.5 * i)
        scans.append(feed.recv())
    ch.close()
    assert feed.recv() is None
    for i, raw in enumerate(scans):
        np.testing.assert_array_equal(raw.xyz[:5].numpy(), float(i))
        assert raw.valid[:5].all() and not raw.valid[5:].any()
        assert raw.stamp.dtype == torch.float32 and float(raw.stamp) == 0.5 * i


def test_streaming_loop_is_bit_equal_to_replay(tmp_path):
    """``run.stream`` (channel → DeviceFeed → one ``slam_step`` a scan)
    gives ``replay``'s outputs and final state bit for bit, and writes the
    ``_live`` map artifacts every ``publish_every``-th mapping cycle."""
    _, cfg = small_cfgs()
    scans, _gt, times = make_sequence(12, cfg, seed=1, noise=0.01)
    x, v, t = pack_sequence(scans, times, cfg, device="cpu")
    ref_state, ref = replay(x, v, t, cfg, device="cpu")
    state, outs, latency_ms, mapped = trun.stream(
        scans, times, cfg, torch.device("cpu"), output=str(tmp_path),
        publish_every=1)
    assert outs.keys() == ref.keys()
    for k in ref:
        assert torch.equal(outs[k], ref[k]), k
    assert state.scan_index == ref_state.scan_index == 12

    def walk(a, r, path=""):
        if isinstance(r, dict):
            for k in r:
                walk(a[k], r[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(a, r, err_msg=path)
    walk(convert.to_numpy_tree(state), convert.to_numpy_tree(ref_state))
    assert len(latency_ms) == 12 and all(ms > 0 for ms in latency_ms)
    assert mapped == [i % 5 == 4 for i in range(12)]
    assert (tmp_path / "keyframe_poses_live.npy").is_file()
    summary = trun.latency_summary(latency_ms, mapped, 100.0)
    assert summary["p50_ms"] <= summary["p99_ms"] <= summary["max_ms"]
    assert summary["p50_ms_mapping"] > 0 and summary["p50_ms_other"] > 0

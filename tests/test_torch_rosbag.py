"""The port's ``io/rosbag.py`` against the JAX package's, on the cases of
``tests/test_rosbag.py``: the same bags byte for byte from both writers,
the same arrays from both readers on plain, ``bz2`` and ``lz4`` chunks, the
same PointCloud2 codec and LZ4 decoder, and the same ``.npz`` from both
converters.  (The bag through the port's CLI is in
``tests/test_torch_cli.py``.)"""

import bz2
import struct

import numpy as np
import pytest

from lego_loam_tpu.io import npz_io as jnpz
from lego_loam_tpu.io import rosbag as jrb
from lego_loam_tpu_torch.io import npz_io as tnpz
from lego_loam_tpu_torch.io import rosbag as trb


def _rand_scan(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32) * 10.0


def _velodyne_message(n=64):
    """VLP-16 driver layout: x,y,z,intensity f4 + ring u2 + time f4, with
    point_step padding (22 bytes packed into a 32-byte stride)."""
    dt = np.dtype({"names": ["x", "y", "z", "intensity", "ring", "time"],
                   "formats": ["<f4"] * 4 + ["<u2", "<f4"],
                   "offsets": [0, 4, 8, 16, 20, 24], "itemsize": 32})
    rec = np.zeros(n, dt)
    rec["x"] = np.arange(n)
    rec["ring"] = np.arange(n) % 16
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
              ("intensity", 16, 7, 1), ("ring", 20, 4, 1),
              ("time", 24, 7, 1)]
    body = [struct.pack("<III", 0, 10, 500000000),
            struct.pack("<I", 8), b"velodyne",
            struct.pack("<II", 1, n), struct.pack("<I", len(fields))]
    for name, off, code, cnt in fields:
        nb = name.encode()
        body += [struct.pack("<I", len(nb)), nb,
                 struct.pack("<IBI", off, code, cnt)]
    data = rec.tobytes()
    body += [b"\x00", struct.pack("<II", 32, 32 * n),
             struct.pack("<I", len(data)), data, b"\x01"]
    return b"".join(body)


def _assert_decoded_equal(got, ref):
    (gp, gs, gm), (rp, rs, rm) = got, ref
    assert gs == rs and gm == rm
    assert gp.dtype == rp.dtype
    for name in rp.dtype.names:
        np.testing.assert_array_equal(gp[name], rp[name])


@pytest.mark.parametrize("layout", ["xyz_intensity", "velodyne"])
def test_pointcloud2_codec_equals_original(layout):
    if layout == "velodyne":
        msg = _velodyne_message()
    else:
        xyz = _rand_scan(1000, 0)
        inten = np.arange(1000, dtype=np.float32)
        msg = jrb.encode_pointcloud2(xyz, 123.456, intensity=inten, seq=7)
        assert trb.encode_pointcloud2(xyz, 123.456, intensity=inten,
                                      seq=7) == msg
    _assert_decoded_equal(trb.decode_pointcloud2(msg),
                          jrb.decode_pointcloud2(msg))


def test_written_bags_are_byte_equal_and_indexed(tmp_path):
    scans = [_rand_scan(500 + 10 * i, i) for i in range(5)]
    times = [1700000000.0 + 0.1 * i for i in range(5)]
    for topic in ("/velodyne_points", "/lidar_points"):
        jp, tp = str(tmp_path / "j.bag"), str(tmp_path / "t.bag")
        jrb.write_bag(jp, scans, times, topic=topic)
        trb.write_bag(tp, scans, times, topic=topic)
        raw = open(tp, "rb").read()
        assert raw == open(jp, "rb").read()
    # the copy's record reader sees the index the writer emits
    ops, index_pos = [], None
    for header, _ in trb._iter_records(raw[len(trb.MAGIC):]):
        op = header.get(b"op", b"\x00")[0]
        ops.append(op)
        if op == trb.OP_BAG_HEADER:
            (index_pos,) = struct.unpack("<Q", header[b"index_pos"])
    assert trb.OP_INDEX in ops and trb.OP_CHUNK_INFO in ops
    assert index_pos and index_pos > 0


def _recompress(path, out_path, compression):
    """Rewrite the chunk record of a written bag as ``bz2`` (what ``rosbag
    record --bz2`` writes) or an LZ4 frame of stored blocks."""
    raw = open(path, "rb").read()
    out = [jrb.MAGIC]
    for header, data in jrb._iter_records(raw[len(jrb.MAGIC):]):
        if header.get(b"op", b"\x00")[0] == jrb.OP_CHUNK:
            header = dict(header)
            header[b"compression"] = compression.encode()
            if compression == "bz2":
                data = bz2.compress(data)
            else:
                data = (struct.pack("<I", 0x184D2204)
                        + bytes([0x40, 0x70, 0x00])
                        + struct.pack("<I", 0x80000000 | len(data)) + data
                        + struct.pack("<I", 0))
        h = jrb._encode_fields(header)
        out += [struct.pack("<I", len(h)), h,
                struct.pack("<I", len(data)), data]
    open(out_path, "wb").write(b"".join(out))


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bags_read_equal_to_original(tmp_path, compression):
    scans = [_rand_scan(200 + 50 * i, 3 + i) for i in range(3)]
    times = [10.0, 10.1, 10.2]
    path = str(tmp_path / "plain.bag")
    trb.write_bag(path, scans, times, topic="/velodyne_points")
    if compression != "none":
        _recompress(path, str(tmp_path / "c.bag"), compression)
        path = str(tmp_path / "c.bag")
    got, ref = trb.load_bag(path), jrb.load_bag(path)
    assert got[1] is None and ref[1] is None
    assert len(got[0]) == len(ref[0]) == 3
    for g, r, s in zip(got[0], ref[0], scans):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, s)
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].dtype == ref[2].dtype
    assert len(trb.load_bag(path, topic="/velodyne_points",
                            max_scans=2)[0]) == 2
    with pytest.raises(ValueError, match="no sensor_msgs/PointCloud2"):
        trb.load_bag(path, topic="/other")
    for (gt_, gp, gs, gm), (rt, rp, rs, rm) in zip(
            trb.read_pointcloud2_messages(path),
            jrb.read_pointcloud2_messages(path)):
        assert (gt_, gs, gm) == (rt, rs, rm)
        assert gt_ == "/velodyne_points" and gm["frame_id"] == "velodyne"
        np.testing.assert_array_equal(gp, rp)


def test_lz4_block_and_frame_decode_equal_original():
    """Hand-built LZ4 frame: one compressed block (literals + overlapping
    match) and one stored block."""
    block = bytes([0x44]) + b"ABCD" + struct.pack("<H", 4)
    got, ref = bytearray(), bytearray()
    trb._lz4_block_decompress(block, got)
    jrb._lz4_block_decompress(block, ref)
    assert bytes(got) == bytes(ref) == b"ABCDABCDABCD"
    stored = b"hello world"
    frame = (struct.pack("<I", 0x184D2204) + bytes([0x40, 0x70, 0x00])
             + struct.pack("<I", len(block)) + block
             + struct.pack("<I", 0x80000000 | len(stored)) + stored
             + struct.pack("<I", 0))
    assert trb._lz4_frame_decompress(frame) \
        == jrb._lz4_frame_decompress(frame) == b"ABCDABCDABCD" + stored


def test_bag_to_npz_converter_equals_original(tmp_path, capsys):
    scans = [_rand_scan(100, i) for i in range(4)]
    path = str(tmp_path / "seq.bag")
    trb.write_bag(path, scans, [5.0 + 0.1 * i for i in range(4)])
    trb.main([path, str(tmp_path / "t.npz"), "--max-scans", "3"])
    jrb.main([path, str(tmp_path / "j.npz"), "--max-scans", "3"])
    got = tnpz.load_sequence(str(tmp_path / "t.npz"))
    ref = jnpz.load_sequence(str(tmp_path / "j.npz"))
    assert len(got[0]) == len(ref[0]) == 3 and got[1] is ref[1] is None
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[2], ref[2])
    assert "3 scans" in capsys.readouterr().out

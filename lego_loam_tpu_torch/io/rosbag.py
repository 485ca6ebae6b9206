"""Dependency-free rosbag v2.0 reader/writer for ``sensor_msgs/PointCloud2``.

The reference's only input path is a ROS1 bag of PointCloud2 scans replayed
by the driver (``LeGO-LOAM/src/main.cpp:59-95``; topic ``/lidar_points``
remapped from ``/velodyne_points``, ``imageProjection.cpp:37-38``,
``launch/run.launch:23``).  A user switching from the reference has bags,
not .npz archives — this module ingests them directly, with no ROS
installation: the bag container format and the PointCloud2 wire format are
both fixed, documented layouts parseable with ``struct`` + numpy.

Supported: bag format 2.0, chunk compression ``none``, ``bz2`` (stdlib)
and ``lz4`` (the roslz4 LZ4-frame layout, decoded by the pure-python
block decompressor below — slower than native lz4 but dependency-free;
checksums are skipped).  Messages are decoded via a numpy structured
dtype built from the PointField table, so arbitrary field layouts
(VLP-16 x/y/z/intensity/ring/time, HDL-64, Ouster) all work.

The writer emits a single-chunk uncompressed bag WITH index records
(IndexData per connection + ChunkInfo + index_pos in the bag header), so
standard ROS tooling opens it without a re-index pass.

The port's own copy of the JAX package's ``io/rosbag.py`` (NumPy and the
standard library only; ``tests/test_torch_rosbag.py`` holds the two equal,
bag bytes and decoded arrays).  It returns NumPy arrays; ``io/npz_io.py::
pack_sequence`` puts the scans on the device.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

# record ops (rosbag/include/rosbag/constants.h in upstream ROS)
OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

POINTCLOUD2_TYPE = "sensor_msgs/PointCloud2"
POINTCLOUD2_MD5 = "1158d486dd51d683ce2f1be655c3c181"

# PointField.datatype enum → numpy dtype char
_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2",
              5: "i4", 6: "u4", 7: "f4", 8: "f8"}
_PF_CODES = {v: k for k, v in _PF_DTYPES.items()}


# ---------------------------------------------------------------- records

def _parse_fields(buf: bytes) -> Dict[bytes, bytes]:
    """A record header / connection-data block: repeated
    ``len(u32) name=value`` fields."""
    fields, off = {}, 0
    while off < len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + n]
        off += n
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _encode_fields(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        body = k + b"=" + v
        out += struct.pack("<I", len(body)) + body
    return out


def _iter_records(buf: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Yield (header_fields, data) for each record in ``buf``."""
    off = 0
    while off < len(buf):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_fields(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _lz4_block_decompress(src: bytes, dst: bytearray) -> None:
    """LZ4 block format (the LZ77 core): token = (lit_len<<4)|match_len,
    15 ⇒ extended with 255-runs; match = u16le offset + len+4 bytes,
    copied byte-serially because matches may overlap their output."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        dst += src[i:i + lit]
        i += lit
        if i >= n:            # last sequence has no match part
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - off
        if off >= mlen:       # non-overlapping: one slice copy
            dst += dst[start:start + mlen]
        else:
            for k in range(mlen):
                dst.append(dst[start + k])


def _lz4_frame_decompress(data: bytes) -> bytes:
    """roslz4's LZ4 frame layout (lz4s.c): magic 0x184D2204, FLG/BD
    descriptor (+1-byte header checksum), then blocks of
    ``u32 size`` (+data); high size bit ⇒ stored uncompressed; size 0 ⇒
    end mark.  Block/content xxhash checksums are skipped, not verified."""
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != 0x184D2204:
        raise ValueError(f"bad LZ4 frame magic {magic:#x}")
    flg = data[4]
    off = 6                             # magic + FLG + BD
    block_checksum = bool(flg & 0x10)
    content_size = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    if content_size:
        off += 8
    off += 1                            # header checksum byte
    out = bytearray()
    while off < len(data):
        (bsize,) = struct.unpack_from("<I", data, off)
        off += 4
        if bsize == 0:                  # end mark
            if content_checksum:
                off += 4
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = data[off:off + bsize]
        off += bsize
        if block_checksum:
            off += 4
        if stored:
            out += block
        else:
            _lz4_block_decompress(block, out)
    return bytes(out)


def _decompress(data: bytes, compression: bytes) -> bytes:
    if compression in (b"none", b""):
        return data
    if compression == b"bz2":
        return bz2.decompress(data)
    if compression == b"lz4":
        return _lz4_frame_decompress(data)
    raise NotImplementedError(
        f"bag chunk compression {compression!r} not supported "
        "(only none/bz2/lz4); re-record with `rosbag decompress`")


# ---------------------------------------------------- PointCloud2 decode

def _read_string(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4:off + 4 + n], off + 4 + n


def decode_pointcloud2(msg: bytes) -> Tuple[np.ndarray, float, dict]:
    """Serialized PointCloud2 → (structured (N,) array, stamp_sec, meta).

    Wire layout per the ROS msg definition: Header(seq u32, stamp 2×u32,
    frame_id string), height u32, width u32, fields PointField[], u8
    is_bigendian, point_step u32, row_step u32, data u8[], u8 is_dense.
    """
    off = 4  # skip Header.seq
    secs, nsecs = struct.unpack_from("<II", msg, off)
    off += 8
    frame_id, off = _read_string(msg, off)
    height, width = struct.unpack_from("<II", msg, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", msg, off)
    off += 4
    names, formats, offsets = [], [], []
    for _ in range(n_fields):
        name, off = _read_string(msg, off)
        f_off, dt, count = struct.unpack_from("<IBI", msg, off)
        off += 9
        if dt not in _PF_DTYPES:
            raise ValueError(f"unknown PointField datatype {dt}")
        base = _PF_DTYPES[dt]
        names.append(name.decode())
        formats.append(base if count == 1 else (base, (count,)))
        offsets.append(f_off)
    is_bigendian = msg[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", msg, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", msg, off)
    off += 4
    data = msg[off:off + dlen]
    off += dlen
    is_dense = msg[off] if off < len(msg) else 1

    dtype = np.dtype({"names": names, "formats": formats,
                      "offsets": offsets, "itemsize": point_step})
    if is_bigendian:
        dtype = dtype.newbyteorder(">")
    n = height * width
    if row_step == point_step * width or height == 1:
        pts = np.frombuffer(data[:n * point_step], dtype=dtype, count=n)
    else:  # padded rows
        rows = np.frombuffer(data, np.uint8,
                             count=height * row_step).reshape(height,
                                                              row_step)
        pts = rows[:, :width * point_step].reshape(-1).view(dtype)
    meta = {"frame_id": frame_id.decode(), "height": int(height),
            "width": int(width), "is_dense": bool(is_dense)}
    return pts, secs + nsecs * 1e-9, meta


def encode_pointcloud2(xyz: np.ndarray, stamp: float,
                       intensity: Optional[np.ndarray] = None,
                       frame_id: str = "velodyne", seq: int = 0) -> bytes:
    """(N,3) float32 (+ optional intensity) → serialized PointCloud2."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = xyz.shape[0]
    names = ["x", "y", "z"] + (["intensity"] if intensity is not None
                               else [])
    rec = np.zeros(n, np.dtype([(m, "<f4") for m in names]))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if intensity is not None:
        rec["intensity"] = np.asarray(intensity, np.float32)
    data = rec.tobytes()

    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    out = [struct.pack("<III", seq, secs, nsecs),
           struct.pack("<I", len(fid)), fid,
           struct.pack("<II", 1, n),              # height, width
           struct.pack("<I", len(names))]
    for i, m in enumerate(names):
        mb = m.encode()
        out += [struct.pack("<I", len(mb)), mb,
                struct.pack("<IBI", 4 * i, _PF_CODES["f4"], 1)]
    step = 4 * len(names)
    out += [b"\x00",                               # is_bigendian
            struct.pack("<II", step, step * n),    # point/row step
            struct.pack("<I", len(data)), data,
            b"\x01"]                               # is_dense
    return b"".join(out)


# ----------------------------------------------------------------- reader

def read_pointcloud2_messages(
        path: str, topic: Optional[str] = None
) -> Iterator[Tuple[str, np.ndarray, float, dict]]:
    """Stream (topic, structured points, stamp, meta) from a bag.

    ``topic=None`` takes every PointCloud2 connection (the reference
    defaults to ``/velodyne_points`` but accepts any via the
    ``lidar_topic`` param, ``main.cpp:21``).
    """
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ROSBAG V2.0 file")
        buf = f.read()

    conn_topic: Dict[int, str] = {}
    conn_ok: Dict[int, bool] = {}

    def handle(header: Dict[bytes, bytes], data: bytes):
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CONNECTION:
            conn = struct.unpack("<I", header[b"conn"])[0]
            info = _parse_fields(data)
            t = header.get(b"topic", info.get(b"topic", b"")).decode()
            conn_topic[conn] = t
            conn_ok[conn] = (
                info.get(b"type", b"").decode() == POINTCLOUD2_TYPE
                and (topic is None or t == topic))
        elif op == OP_MSG:
            conn = struct.unpack("<I", header[b"conn"])[0]
            if conn_ok.get(conn):
                pts, stamp, meta = decode_pointcloud2(data)
                return conn_topic[conn], pts, stamp, meta
        return None

    for header, data in _iter_records(buf):
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CHUNK:
            inner = _decompress(data, header.get(b"compression", b"none"))
            for h2, d2 in _iter_records(inner):
                got = handle(h2, d2)
                if got:
                    yield got
        elif op in (OP_CONNECTION, OP_MSG):  # unchunked (tolerant)
            got = handle(header, data)
            if got:
                yield got
        # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: skipped


def load_bag(path: str, topic: Optional[str] = None,
             max_scans: Optional[int] = None
             ) -> Tuple[List[np.ndarray], None, np.ndarray]:
    """Bag → (scans [(Ni,3) float32 xyz], gt=None, times (N,)) — the
    ``load_sequence`` signature, so ``run.py --input x.bag`` drops in."""
    scans, times = [], []
    for _t, pts, stamp, _m in read_pointcloud2_messages(path, topic):
        xyz = np.stack([np.asarray(pts["x"], np.float32),
                        np.asarray(pts["y"], np.float32),
                        np.asarray(pts["z"], np.float32)], axis=-1)
        scans.append(xyz)
        times.append(stamp)
        if max_scans and len(scans) >= max_scans:
            break
    if not scans:
        raise ValueError(f"{path}: no {POINTCLOUD2_TYPE} messages"
                         + (f" on topic {topic}" if topic else ""))
    t = np.asarray(times, np.float64)
    return scans, None, (t - t[0]).astype(np.float32)


# ----------------------------------------------------------------- writer

def write_bag(path: str, scans: Sequence[np.ndarray],
              times: Sequence[float], topic: str = "/velodyne_points",
              frame_id: str = "velodyne"):
    """Single-chunk uncompressed bag of PointCloud2 messages, fully
    indexed (IndexData + ChunkInfo + index_pos) per the v2.0 layout."""

    def record(header: Dict[bytes, bytes], data: bytes) -> bytes:
        h = _encode_fields(header)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(data)) + data)

    conn_header = {b"op": bytes([OP_CONNECTION]),
                   b"conn": struct.pack("<I", 0),
                   b"topic": topic.encode()}
    conn_info = _encode_fields({
        b"topic": topic.encode(),
        b"type": POINTCLOUD2_TYPE.encode(),
        b"md5sum": POINTCLOUD2_MD5.encode(),
        b"message_definition": b"",
    })
    chunk = record(conn_header, conn_info)
    index_entries = []                    # (secs, nsecs, chunk_offset)
    for i, (xyz, stamp) in enumerate(zip(scans, times)):
        stamp = float(stamp)
        secs, nsecs = int(stamp), int(round((stamp - int(stamp)) * 1e9))
        index_entries.append((secs, nsecs, len(chunk)))
        msg = encode_pointcloud2(xyz, stamp, frame_id=frame_id, seq=i)
        chunk += record({b"op": bytes([OP_MSG]),
                         b"conn": struct.pack("<I", 0),
                         b"time": struct.pack("<II", secs, nsecs)}, msg)

    with open(path, "wb") as f:
        f.write(MAGIC)
        hdr_pos = f.tell()
        # bag header record, padded to 4096 like rosbag does; index_pos
        # back-patched once the chunk length is known
        f.write(record({b"op": bytes([OP_BAG_HEADER]),
                        b"index_pos": struct.pack("<Q", 0),
                        b"conn_count": struct.pack("<I", 1),
                        b"chunk_count": struct.pack("<I", 1)},
                       b" " * 4096))
        chunk_pos = f.tell()
        f.write(record({b"op": bytes([OP_CHUNK]),
                        b"compression": b"none",
                        b"size": struct.pack("<I", len(chunk))}, chunk))
        # IndexData v1: per-connection (time, offset-into-chunk) entries
        idx_data = b"".join(struct.pack("<III", s, ns, off)
                            for s, ns, off in index_entries)
        f.write(record({b"op": bytes([OP_INDEX]),
                        b"ver": struct.pack("<I", 1),
                        b"conn": struct.pack("<I", 0),
                        b"count": struct.pack("<I", len(index_entries))},
                       idx_data))
        index_pos = f.tell()
        # index section: connection records, then ChunkInfo v1
        f.write(record(conn_header, conn_info))
        s0, ns0, _ = index_entries[0] if index_entries else (0, 0, 0)
        s1, ns1, _ = index_entries[-1] if index_entries else (0, 0, 0)
        f.write(record({b"op": bytes([OP_CHUNK_INFO]),
                        b"ver": struct.pack("<I", 1),
                        b"chunk_pos": struct.pack("<Q", chunk_pos),
                        b"start_time": struct.pack("<II", s0, ns0),
                        b"end_time": struct.pack("<II", s1, ns1),
                        b"count": struct.pack("<I", 1)},
                       struct.pack("<II", 0, len(index_entries))))
        # back-patch index_pos in the bag header
        f.seek(hdr_pos)
        f.write(record({b"op": bytes([OP_BAG_HEADER]),
                        b"index_pos": struct.pack("<Q", index_pos),
                        b"conn_count": struct.pack("<I", 1),
                        b"chunk_count": struct.pack("<I", 1)},
                       b" " * 4096))


def main(argv=None):
    """CLI: ``python -m lego_loam_tpu_torch.io.rosbag in.bag out.npz
    [--topic T]``."""
    import argparse

    from .npz_io import save_sequence

    ap = argparse.ArgumentParser(description="rosbag → .npz converter")
    ap.add_argument("bag")
    ap.add_argument("out")
    ap.add_argument("--topic", default=None)
    ap.add_argument("--max-scans", type=int, default=None)
    args = ap.parse_args(argv)
    scans, _gt, times = load_bag(args.bag, args.topic, args.max_scans)
    save_sequence(args.out, scans, None, times)
    print(f"{args.bag}: {len(scans)} scans → {args.out}")


if __name__ == "__main__":
    main()

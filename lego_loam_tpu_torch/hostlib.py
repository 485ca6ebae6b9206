"""Build and load the port's host library (``csrc/feeder.cpp``).

The scan channel and packer of ``io/native_feeder.py`` are host C++ with a
plain C interface.  They are built with the host compiler — not ``nvcc``,
so machines without the CUDA toolkit build them too — at first use into
``build/libfeeder.so`` beside the package (or under
``$LEGO_TORCH_BUILD_DIR``, as the kernels) and loaded with ``ctypes``.  A
content hash of the source and flags sits beside the library, so a changed
source rebuilds.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from .kernels import CSRC, build_dir

_SOURCE = "feeder.cpp"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(os.path.join(CSRC, _SOURCE), "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile ``csrc/feeder.cpp`` into ``libfeeder.so`` unless an
    up-to-date one is there; returns its path."""
    digest = _digest()
    out_dir = os.path.abspath(build_dir())
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libfeeder.so")
    stamp_path = lib_path + ".sha256"
    if os.path.exists(lib_path) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read().strip() == digest:
                return lib_path
    cxx = os.environ.get("CXX", "g++")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    done = subprocess.run(
        [cxx, *_CXX_FLAGS, "-o", tmp, os.path.join(CSRC, _SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {_SOURCE}:\n{done.stdout}")
    os.replace(tmp, lib_path)
    with open(f"{stamp_path}.{os.getpid()}.tmp", "w") as f:
        f.write(digest)
    os.replace(f"{stamp_path}.{os.getpid()}.tmp", stamp_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded host library (built on first call, once however many
    threads ask at the same time)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            # int64 lego_pack_scan(pts, n, capacity, out_xyz, out_valid)
            cdll.lego_pack_scan.argtypes = [p, i64, i64, p, p]
            cdll.lego_pack_scan.restype = i64
            cdll.lego_channel_create.argtypes = [i64, i64]
            cdll.lego_channel_create.restype = p
            cdll.lego_channel_destroy.argtypes = [p]
            cdll.lego_channel_destroy.restype = None
            # int send(ch, pts, n, stamp); int recv(ch, xyz, valid, &stamp)
            cdll.lego_channel_send.argtypes = [p, p, i64, ctypes.c_double]
            cdll.lego_channel_send.restype = ctypes.c_int
            cdll.lego_channel_recv.argtypes = [p, p, p, p]
            cdll.lego_channel_recv.restype = ctypes.c_int
            cdll.lego_channel_close.argtypes = [p]
            cdll.lego_channel_close.restype = None
            cdll.lego_channel_size.argtypes = [p]
            cdll.lego_channel_size.restype = i64
            _lib = cdll
    return _lib

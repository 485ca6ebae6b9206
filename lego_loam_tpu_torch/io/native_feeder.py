"""ctypes bindings for the port's host runtime (``csrc/feeder.cpp``).

The reference's Channel semantics (``channel.h:11-56``) and the per-scan
packing hot path in C++, as in the JAX package's ``io/native_feeder.py``,
whose C interface this keeps.  The library is built by ``hostlib.py`` with
the host compiler; a failed build raises — there is no Python fallback.

:class:`DeviceFeed` is what the GPU adds: a received scan lands in a PINNED
host buffer and goes to the device with a non-blocking copy, so one scan's
copy overlaps the previous scan's work.  Two buffers are used in turn, and
a buffer is filled again only after the CUDA event recorded behind its last
copy has completed: with one buffer, the next ``recv`` would overwrite
memory that a copy still in flight reads.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import hostlib
from ..core.types import RawScan


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def pack_scan_native(points: np.ndarray,
                     capacity: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """NaN-filter + pad to capacity in C++: (xyz (capacity, 3) float32,
    valid (capacity,) bool, number of valid points).  A row with any
    non-finite coordinate is invalid and zero."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out_xyz = np.zeros((capacity, 3), np.float32)
    out_valid = np.zeros((capacity,), np.uint8)
    n_valid = hostlib.lib().lego_pack_scan(
        _ptr(pts), pts.shape[0], capacity, _ptr(out_xyz), _ptr(out_valid))
    return out_xyz, out_valid.astype(bool), int(n_valid)


class ScanChannel:
    """Bounded blocking channel of packed scans — Channel<T> semantics
    (depth=1 ⇒ the reference's deterministic lock-step replay).  One
    producer thread calls :meth:`send`, one consumer :meth:`recv`."""

    def __init__(self, capacity_points: int, depth: int = 1):
        self.capacity = capacity_points
        self.depth = depth
        self._lib = hostlib.lib()
        self._h = self._lib.lego_channel_create(capacity_points, depth)

    def send(self, points: np.ndarray, stamp: float) -> bool:
        """Pack and enqueue one scan (blocks while the channel is full);
        False once the channel is closed."""
        pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        return self._lib.lego_channel_send(
            self._h, _ptr(pts), pts.shape[0], float(stamp)) == 0

    def recv(self, xyz: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None):
        """The next scan as (xyz (C,3) float32, valid (C,) bool, stamp), or
        None once the channel is closed and drained.  Given ``xyz`` and
        ``valid`` (contiguous CPU tensors of those shapes and dtypes, e.g.
        pinned), the scan is written into them and they are returned."""
        if xyz is None:
            xyz = torch.empty((self.capacity, 3), dtype=torch.float32)
            valid = torch.empty((self.capacity,), dtype=torch.bool)
        if (xyz.shape != (self.capacity, 3) or xyz.dtype != torch.float32
                or valid.shape != (self.capacity,)
                or valid.dtype != torch.bool or xyz.device.type != "cpu"
                or valid.device.type != "cpu" or not xyz.is_contiguous()
                or not valid.is_contiguous()):
            raise ValueError("recv needs contiguous CPU buffers "
                             f"({self.capacity}, 3) float32 and "
                             f"({self.capacity},) bool")
        stamp = ctypes.c_double(0.0)
        r = self._lib.lego_channel_recv(     # bool is one byte of 0 / 1
            self._h, ctypes.c_void_p(xyz.data_ptr()),
            ctypes.c_void_p(valid.data_ptr()), ctypes.byref(stamp))
        if r != 0:
            return None
        return xyz, valid, stamp.value

    def close(self) -> None:
        """No more sends; :meth:`recv` drains what is queued, then
        returns None."""
        self._lib.lego_channel_close(self._h)

    def size(self) -> int:
        return int(self._lib.lego_channel_size(self._h))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.lego_channel_destroy(h)


class DeviceFeed:
    """Receives scans from a :class:`ScanChannel` into two pinned host
    buffers in turn and copies each to ``device`` without blocking (see
    the module docstring).  On the CPU the buffers are plain and each scan
    is a copy of its own."""

    def __init__(self, channel: ScanChannel, device: torch.device):
        self.channel = channel
        self.device = device
        pin = device.type == "cuda"
        C = channel.capacity
        self._bufs = [
            (torch.empty((C, 3), dtype=torch.float32, pin_memory=pin),
             torch.empty((C,), dtype=torch.bool, pin_memory=pin),
             torch.empty((), dtype=torch.float32, pin_memory=pin))
            for _ in range(2)]
        self._copied = [None, None]     # CUDA event behind each buffer's copy
        self._next = 0

    def recv(self) -> Optional[RawScan]:
        """The next scan as a :class:`RawScan` on the device, or None once
        the channel is closed and drained."""
        k = self._next
        self._next ^= 1
        if self._copied[k] is not None:
            self._copied[k].synchronize()   # its last copy has read it
        xyz, valid, stamp = self._bufs[k]
        item = self.channel.recv(xyz, valid)
        if item is None:
            return None
        stamp.fill_(item[2])
        raw = RawScan(
            xyz=xyz.to(self.device, non_blocking=True, copy=True),
            valid=valid.to(self.device, non_blocking=True, copy=True),
            stamp=stamp.to(self.device, non_blocking=True, copy=True))
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[k] = ev
        return raw

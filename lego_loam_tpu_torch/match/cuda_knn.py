"""5 nearest valid candidates per query: CUDA kernel + plain version.

Counterpart of the JAX package's ``match/pallas_knn.py``.  Contract of both
versions (that of ``bruteforce.knn_chunked(k=5)``):

    knn5(query (Q,3) f32, query_valid (Q,) bool,
         cand (M,3) f32, cand_valid (M,) bool)
      → idx (Q,5) int32, d2 (Q,5) f32 ascending

* distances are exact difference-first float32 squared distances;
* fewer than five valid candidates leave ``d2 = 3e38`` / ``idx = 0`` in the
  remaining slots (callers detect it by ``d2[:, 4] >= 1e30``);
* an invalid query gets ``d2 = 3e38`` in all five slots; its ``idx`` are
  still the neighbours of its coordinates, so a caller that gathers by
  ``idx`` before masking never sees five copies of one point.

:func:`knn5` dispatches on where the tensors lie: CUDA tensors go to the
hand-written kernel (``csrc/knn5.cu``) or raise; CPU tensors take the plain
version.  There is no fallback between the two and no backend switch:
``MappingConfig.knn_impl`` is kept in the config copy only.

:func:`knn5_grouped` runs up to four such searches at once — on the card in
ONE kernel launch — and returns what the single calls would return, bit for
bit; :func:`knn5` is its one-problem case.  The kernel's scratch (partial
lists of the candidate slices, ticket counters) and its problem descriptors
are cached in a plan per device, CUDA stream and shape tuple, so a call
allocates only its outputs.  Launches that share a plan are ordered on its
one stream, and a lock held from the first pointer written into the plan's
descriptors to the return of the launch keeps two host threads from
overwriting each other's pointers; two streams never share scratch.  A plan
is made outside CUDA-graph capture: capture on a stream the same shapes have
already run on.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import torch

from .bruteforce import pairwise_sqdist

Tensor = torch.Tensor

_INF = 3e38
_MAX_PROBLEMS = 4              # csrc/knn5.cu::kMaxProblems
_SLICE_ALIGN = 16              # candidates: one 16-byte copy of mask bytes
_TILE = 256                    # csrc/knn5.cu::kTile: a long slice is whole tiles
_MIN_SLICE = 256               # candidates a slice is worth at least
_MAX_SPLITS = 32               # lists one thread merges per query
_BLOCKS_PER_SM = 8             # blocks wanted on each SM

launch_count = 0     # +1 per kernel launch made by knn5_cuda_grouped
_count_lock = threading.Lock()


def knn5_torch(query: Tensor, query_valid: Tensor, cand: Tensor,
               cand_valid: Tensor):
    """Plain version: recentred distance matrix + ``topk``, then the exact
    difference-first distances of the winners, re-sorted ascending."""
    d2 = pairwise_sqdist(query, cand)
    d2 = torch.where(cand_valid[None, :], d2, _INF)
    sel_d, idx = torch.topk(d2, 5, dim=-1, largest=False, sorted=True)
    real = sel_d < 1e30                                  # a valid candidate
    nb = cand[idx]                                       # (Q, 5, 3)
    diff = nb - query[:, None, :]
    exact = torch.sum(diff * diff, dim=-1)
    exact = torch.where(real, exact, _INF)
    idx = torch.where(real, idx, 0)
    # the matrix is only good for ranking; restore exact ascending order
    # (stable: equal distances keep the matrix order)
    exact, order = torch.sort(exact, dim=1, stable=True)
    idx = torch.gather(idx, 1, order)
    exact = torch.where(query_valid[:, None], exact, _INF)
    return idx.to(torch.int32), exact


class Geometry(NamedTuple):
    """How one search is cut into blocks: ``qblocks`` groups of
    ``query_block`` queries times ``splits`` candidate slices of ``chunk``
    candidates each."""
    qblocks: int
    splits: int
    chunk: int
    query_block: int

    @property
    def blocks(self) -> int:
        return self.qblocks * self.splits

    @property
    def scratch_entries(self) -> int:
        """(d2, id) pairs of partial lists, six a list (five and one of
        padding); none when nothing is merged."""
        if self.splits == 1:
            return 0
        return self.blocks * 6 * self.query_block


def launch_geometry(Q: int, M: int, sm_count: int,
                    query_block: int) -> Geometry:
    """``query_block`` is the kernel's own (``knn5_query_block()`` of the
    library).  Slices per query block so that ``_BLOCKS_PER_SM`` blocks exist for
    every SM where Q * M allows: no slice shorter than ``_MIN_SLICE``
    (unless M is), no more than ``_MAX_SPLITS`` of them, every slice
    non-empty, and the slices cover [0, M) exactly once."""
    qblocks = -(-Q // query_block)
    want = -(-_BLOCKS_PER_SM * sm_count // max(qblocks, 1))
    splits = max(1, min(want, _MAX_SPLITS, M // _MIN_SLICE))
    chunk = -(-max(M, 1) // splits)
    align = _TILE if chunk >= 2 * _TILE else _SLICE_ALIGN
    chunk = -(-chunk // align) * align
    splits = max(1, -(-M // chunk))
    return Geometry(qblocks, splits, chunk, query_block)


class _Problem(ctypes.Structure):
    """csrc/knn5.cu::Problem."""
    _fields_ = [("query", ctypes.c_void_p), ("query_valid", ctypes.c_void_p),
                ("cand", ctypes.c_void_p), ("cand_valid", ctypes.c_void_p),
                ("out_idx", ctypes.c_void_p), ("out_d2", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
                ("Q", ctypes.c_int), ("M", ctypes.c_int),
                ("splits", ctypes.c_int), ("chunk", ctypes.c_int),
                ("block_begin", ctypes.c_int), ("pad_", ctypes.c_int)]


class _Batch(ctypes.Structure):
    """csrc/knn5.cu::Batch."""
    _fields_ = [("p", _Problem * _MAX_PROBLEMS), ("n", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _Plan:
    """Everything of a launch that depends only on the device, the stream
    and the shapes: geometry, scratch, and a descriptor block whose pointer
    fields are filled in per call, under ``lock``."""

    def __init__(self, dev: torch.device, shapes):
        from ..kernels import lib
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        query_block = lib().knn5_query_block()
        self.geometry = [launch_geometry(Q, M, sm_count, query_block)
                         for Q, M in shapes]
        for (Q, M), g in zip(shapes, self.geometry):
            if (max(g.scratch_entries, 5 * Q, 3 * M) >= 2 ** 31
                    or g.blocks >= 2 ** 31):
                raise ValueError("point set too large for 32-bit offsets")
        self.blocks = sum(g.blocks for g in self.geometry)
        if self.blocks >= 2 ** 31:
            raise ValueError("too many blocks for one launch")
        # float2 entries; counters are zero between launches (the block
        # that draws a counter's last ticket resets it)
        self.part = torch.empty(
            (max(1, sum(g.scratch_entries for g in self.geometry)), 2),
            dtype=torch.float32, device=dev)
        self.tickets = torch.zeros(
            (max(1, sum(g.qblocks for g in self.geometry)),),
            dtype=torch.int32, device=dev)
        self.batch = _Batch()
        self.batch.n = len(shapes)
        part_at, ticket_at, block_at = 0, 0, 0
        for k, ((Q, M), g) in enumerate(zip(shapes, self.geometry)):
            d = self.batch.p[k]
            d.Q, d.M, d.splits, d.chunk = Q, M, g.splits, g.chunk
            d.block_begin = block_at
            d.part = self.part.data_ptr() + 8 * part_at
            d.tickets = self.tickets.data_ptr() + 4 * ticket_at
            part_at += g.scratch_entries
            ticket_at += g.qblocks
            block_at += g.blocks
        self.batch_ref = ctypes.byref(self.batch)
        self.lock = threading.Lock()


_plans: dict = {}
_plans_lock = threading.Lock()


def _check_problem(k: int, query: Tensor, query_valid: Tensor, cand: Tensor,
                   cand_valid: Tensor, dev: torch.device) -> None:
    """Raise on what the kernel does not take."""
    for name, t, dtype, tail in (
            ("query", query, torch.float32, (3,)),
            ("query_valid", query_valid, torch.bool, ()),
            ("cand", cand, torch.float32, (3,)),
            ("cand_valid", cand_valid, torch.bool, ())):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"problem {k}: {name} must be a CUDA tensor on "
                             f"{dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"problem {k}: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
            raise ValueError(f"problem {k}: {name} has shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"problem {k}: {name} must be contiguous")
    if (query_valid.shape[0] != query.shape[0]
            or cand_valid.shape[0] != cand.shape[0]):
        raise ValueError(f"problem {k}: mask length does not match its "
                         f"point set")


def knn5_cuda_grouped(problems: Sequence[tuple]):
    """Launch the kernel (``csrc/knn5.cu``) ONCE, on the current stream, for
    up to four searches ``(query, query_valid, cand, cand_valid)``:
    contiguous CUDA tensors on one device, float32 points, bool masks.
    Returns one ``(idx, d2)`` per search."""
    global launch_count
    from ..kernels import lib

    if not 1 <= len(problems) <= _MAX_PROBLEMS:
        raise ValueError(f"1 to {_MAX_PROBLEMS} problems a launch, "
                         f"got {len(problems)}")
    dev = problems[0][0].device
    f32, boolean = torch.float32, torch.bool
    for k, (q, qv, c, cv) in enumerate(problems):
        # one pass over what the kernel relies on; the slow path names the
        # offender
        if not (q.is_cuda and q.device == qv.device == c.device == cv.device
                == dev and q.dtype is f32 and c.dtype is f32
                and qv.dtype is boolean and cv.dtype is boolean
                and q.dim() == 2 and c.dim() == 2 and qv.dim() == 1
                and cv.dim() == 1 and q.shape[1] == 3 and c.shape[1] == 3
                and qv.shape[0] == q.shape[0] and cv.shape[0] == c.shape[0]
                and q.is_contiguous() and qv.is_contiguous()
                and c.is_contiguous() and cv.is_contiguous()):
            _check_problem(k, q, qv, c, cv, dev)
            raise ValueError(f"problem {k}: tensors the kernel cannot take")

    shapes = tuple((p[0].shape[0], p[2].shape[0]) for p in problems)
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream, shapes)
    with _plans_lock:
        plan = _plans.get(key)
        if plan is None:
            if torch.cuda.is_current_stream_capturing():
                # the plan's zeroed counters would exist only in the graph
                raise RuntimeError(
                    "knn5: no plan for these shapes on the stream being "
                    "captured; call once on that stream before capturing")
            plan = _plans[key] = _Plan(dev, shapes)

    staged, results = [], []
    for (q, qv, c, cv), (Q, _) in zip(problems, shapes):
        # the tile copies are 16 bytes wide: a view that starts off that
        # grid is staged through an aligned copy
        if c.data_ptr() % 16:
            c = c.clone()
        if cv.data_ptr() % 16:
            cv = cv.clone()
        staged.append((q, qv, c, cv))
        results.append((torch.empty((Q, 5), dtype=torch.int32, device=dev),
                        torch.empty((Q, 5), dtype=torch.float32, device=dev)))
    if plan.blocks == 0:
        return results
    with plan.lock:
        for d, (q, qv, c, cv), (out_idx, out_d2) in zip(plan.batch.p, staged,
                                                        results):
            d.query, d.query_valid = q.data_ptr(), qv.data_ptr()
            d.cand, d.cand_valid = c.data_ptr(), cv.data_ptr()
            d.out_idx, d.out_d2 = out_idx.data_ptr(), out_d2.data_ptr()
        if torch.cuda.current_device() == dev.index:
            err = lib().knn5_batch(plan.batch_ref, plan.blocks,
                                   stream.cuda_stream)
        else:
            with torch.cuda.device(dev):
                err = lib().knn5_batch(plan.batch_ref, plan.blocks,
                                       stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn5 launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
    return results


def knn5_cuda(query: Tensor, query_valid: Tensor, cand: Tensor,
              cand_valid: Tensor):
    """One search through the kernel: the one-problem case of
    :func:`knn5_cuda_grouped`."""
    return knn5_cuda_grouped([(query, query_valid, cand, cand_valid)])[0]


def knn5_grouped(problems: Sequence[tuple]):
    """Several searches at once: one kernel launch for CUDA tensors, the
    plain version on each for CPU tensors.  Same results as single
    :func:`knn5` calls."""
    if problems[0][0].is_cuda:
        return knn5_cuda_grouped(problems)
    return [knn5_torch(*p) for p in problems]


def knn5(query: Tensor, query_valid: Tensor, cand: Tensor,
         cand_valid: Tensor):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if query.is_cuda:
        return knn5_cuda(query, query_valid, cand, cand_valid)
    return knn5_torch(query, query_valid, cand, cand_valid)

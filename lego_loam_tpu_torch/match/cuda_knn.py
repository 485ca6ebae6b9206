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
"""

from __future__ import annotations

import torch

from .bruteforce import pairwise_sqdist

Tensor = torch.Tensor

_INF = 3e38
_QUERIES_PER_BLOCK = 128       # csrc/knn5.cu::kQueriesPerBlock
_TARGET_BLOCKS = 264           # two blocks for each of an H100's 132 SMs
_MAX_SPLITS = 16

launch_count = 0     # +1 per kernel launch made by knn5_cuda


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


def _splits(Q: int, M: int) -> int:
    """Candidate slices per query block, so the grid fills the card."""
    blocks = -(-Q // _QUERIES_PER_BLOCK)
    want = -(-_TARGET_BLOCKS // max(blocks, 1))
    most = max(1, -(-M // 1024))                          # ≥ one tile each
    return max(1, min(want, _MAX_SPLITS, most))


def knn5_cuda(query: Tensor, query_valid: Tensor, cand: Tensor,
              cand_valid: Tensor):
    """Launch the fused kernel (``csrc/knn5.cu``) on the current stream.
    Takes contiguous CUDA tensors on one device: float32 points, bool
    masks."""
    global launch_count
    from ..kernels import lib

    dev = query.device
    for name, t, dtype, tail in (
            ("query", query, torch.float32, (3,)),
            ("query_valid", query_valid, torch.bool, ()),
            ("cand", cand, torch.float32, (3,)),
            ("cand_valid", cand_valid, torch.bool, ())):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Q, M = query.shape[0], cand.shape[0]
    if query_valid.shape[0] != Q or cand_valid.shape[0] != M:
        raise ValueError("mask length does not match its point set")
    if Q * _MAX_SPLITS * 5 >= 2 ** 31 or 3 * M >= 2 ** 31:
        raise ValueError("point set too large for 32-bit offsets")

    splits = _splits(Q, M)
    part_d2 = torch.empty((Q, splits, 5), dtype=torch.float32, device=dev)
    part_idx = torch.empty((Q, splits, 5), dtype=torch.int32, device=dev)
    out_idx = torch.empty((Q, 5), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((Q, 5), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib().knn5(query.data_ptr(), query_valid.data_ptr(),
                         cand.data_ptr(), cand_valid.data_ptr(),
                         part_d2.data_ptr(), part_idx.data_ptr(),
                         out_idx.data_ptr(), out_d2.data_ptr(),
                         Q, M, splits, stream)
    if err != 0:
        raise RuntimeError(f"knn5 launch failed: CUDA error {err}")
    launch_count += 1
    return out_idx, out_d2


def knn5(query: Tensor, query_valid: Tensor, cand: Tensor,
         cand_valid: Tensor):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if query.is_cuda:
        return knn5_cuda(query, query_valid, cand, cand_valid)
    return knn5_torch(query, query_valid, cand, cand_valid)

"""Connected-component label propagation: CUDA kernel + plain version.

Counterpart of the JAX package's ``frontend/pallas_label.py``.  Contract of
both versions: given

* ``labels0`` (V, H) int32 — flat pixel index on segmentable pixels,
  sentinel ``2**30`` elsewhere,
* ``right`` (V, H) bool, or int32 0/1 — edge (i,j)↔(i,j+1 mod H),
  including the H−1↔0 wrap,
* ``down`` (V, H) bool, or int32 0/1 — edge (i,j)↔(i+1,j),

return (V, H) int32 labels where every segmentable pixel carries the minimum
flat index of its component and every other pixel the sentinel.  Edges only
join segmentable pixels.  Both versions also take B images at once, (B, V,
H) each (flat indices count within an image), and label each as a call of
its own would: the kernel in ONE launch for all B (the counterpart of the
TPU kernel under ``jax.vmap``).

:func:`propagate_labels` dispatches on where the tensor lies: a CUDA tensor
goes to the hand-written union-find kernel (``csrc/label.cu``) or raises; a
CPU tensor takes the plain version.  There is no fallback between the two.
"""

from __future__ import annotations

import math
import threading

import torch

Tensor = torch.Tensor

SENTINEL = 2 ** 30

launch_count = 0     # +1 per kernel launch made by propagate_labels_cuda
_count_lock = threading.Lock()


def _shift(x: Tensor, s: int, dim: int, fill) -> Tensor:
    """Value at index j becomes x[j-s] (s>0) with ``fill`` for j<s; s<0
    shifts the other way."""
    n = x.shape[dim]
    if abs(s) >= n:
        return torch.full_like(x, fill)
    pad = torch.full_like(x.narrow(dim, 0, abs(s)), fill)
    if s >= 0:
        return torch.cat([pad, x.narrow(dim, 0, n - s)], dim)
    return torch.cat([x.narrow(dim, -s, n + s), pad], dim)


def _segmented_sweep(lab: Tensor, conn: Tensor, dim: int, reverse: bool,
                     n_steps: int) -> Tensor:
    """Segmented min-scan along ``dim`` via log-doubling.

    ``conn[j]`` is True iff element j is edge-connected to its predecessor
    (successor when ``reverse``) along the axis.
    """
    sgn = -1 if reverse else 1
    g = conn
    v = lab
    for k in range(n_steps):
        s = sgn * (1 << k)
        v_sh = _shift(v, s, dim, SENTINEL)
        v = torch.minimum(v, torch.where(g, v_sh, SENTINEL))
        g = g & _shift(g, s, dim, False)
    return v


def propagate_labels_torch(labels0: Tensor, right: Tensor, down: Tensor,
                           max_sweeps: int = 64) -> Tensor:
    """Plain version: the fixed-point min-label flood in tensor ops, on
    (V, H) or (B, V, H) images.

    Per sweep a segmented min-scan along rows forward/backward and columns
    down/up, then the wrap-column min; repeated until no label changes or
    ``max_sweeps`` further sweeps have run (one host read per sweep).  On a
    batch every image takes the sweeps of the slowest: a sweep leaves an
    image at its fixed point unchanged, so each image ends where a call of
    its own would have ended.
    """
    V, H = labels0.shape[-2:]
    row_steps = max(1, math.ceil(math.log2(H)))
    col_steps = max(1, math.ceil(math.log2(V)))
    right_b = right != 0
    down_b = down != 0

    wrap = right_b[..., H - 1]                     # column H-1 ↔ 0
    inner = right_b.clone()
    inner[..., H - 1] = False                      # scans do not wrap
    conn_fwd = _shift(inner, 1, -1, False)         # j connected to j-1
    conn_bwd = inner                               # j connected to j+1
    conn_dn = _shift(down_b, 1, -2, False)         # i connected to i-1
    conn_up = down_b.clone()                       # i connected to i+1
    conn_up[..., V - 1, :] = False

    def sweep(lab):
        lab = _segmented_sweep(lab, conn_fwd, -1, False, row_steps)
        lab = _segmented_sweep(lab, conn_bwd, -1, True, row_steps)
        lab = _segmented_sweep(lab, conn_dn, -2, False, col_steps)
        lab = _segmented_sweep(lab, conn_up, -2, True, col_steps)
        mn = torch.minimum(lab[..., 0], lab[..., H - 1])
        lab = lab.clone()
        lab[..., 0] = torch.where(wrap, mn, lab[..., 0])
        lab[..., H - 1] = torch.where(wrap, mn, lab[..., H - 1])
        return lab

    lab = sweep(labels0)
    for _ in range(max_sweeps):
        new = sweep(lab)
        changed = bool(torch.any(new != lab).item())
        lab = new
        if not changed:
            break
    return lab


def propagate_labels_cuda(labels0: Tensor, right: Tensor,
                          down: Tensor) -> Tensor:
    """Launch the union-find kernel (``csrc/label.cu``) ONCE on the current
    stream.  Takes contiguous (V, H) or (B, V, H) CUDA tensors on one
    device: ``labels0`` int32, ``right`` and ``down`` both bool or both
    int32; B images are labelled in the one launch.  An image whose rows fit
    the shared memory of a cluster of up to 8 thread blocks takes the
    cluster kernel, any other the tiled cooperative kernel: the image size
    decides, and nothing else does."""
    global launch_count
    from ..kernels import lib

    dev, shape, edge = labels0.device, labels0.shape, right.dtype
    if not (labels0.is_cuda and labels0.dim() in (2, 3)
            and labels0.dtype is torch.int32
            and (edge is torch.bool or edge is torch.int32)
            and down.dtype is edge and right.device == down.device == dev
            and right.shape == down.shape == shape
            and labels0.is_contiguous() and right.is_contiguous()
            and down.is_contiguous()):
        _refuse(labels0, right, down)
    V, H = shape[-2:]
    B = shape[0] if len(shape) == 3 else 1
    if V * H >= SENTINEL:
        raise ValueError("image too large for the 2**30 sentinel")
    if B * V * H >= 2 ** 31:
        raise ValueError("batch too large for 32-bit pixel offsets")

    out = torch.empty_like(labels0)
    if B * V * H == 0:
        return out
    args = (labels0.data_ptr(), right.data_ptr(), down.data_ptr(),
            out.data_ptr(), B, V, H, 1 if edge is torch.bool else 4)
    if torch.cuda.current_device() == dev.index:
        err = lib().label_ccl(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib().label_ccl(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"label_ccl launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
    return out


def _refuse(labels0: Tensor, right: Tensor, down: Tensor) -> None:
    """Name what the kernel cannot take."""
    if labels0.dim() not in (2, 3):
        raise ValueError(f"labels0 must be (V, H) or (B, V, H), got "
                         f"{tuple(labels0.shape)}")
    if labels0.dtype != torch.int32:
        raise TypeError(f"labels0 must be int32, got {labels0.dtype}")
    if right.dtype not in (torch.bool, torch.int32) or down.dtype != right.dtype:
        raise TypeError(f"right and down must both be bool or both int32, "
                        f"got {right.dtype} and {down.dtype}")
    for name, t in (("labels0", labels0), ("right", right), ("down", down)):
        if not t.is_cuda or t.device != labels0.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{labels0.device}, got {t.device}")
        if t.shape != labels0.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(labels0.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    raise ValueError("tensors the kernel cannot take")


def propagate_labels(labels0: Tensor, right: Tensor, down: Tensor,
                     max_sweeps: int = 64) -> Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors.

    ``max_sweeps`` only bounds the plain version's flood; the kernel's
    union-find needs no cap."""
    if labels0.is_cuda:
        return propagate_labels_cuda(labels0, right, down)
    return propagate_labels_torch(labels0, right, down, max_sweeps)

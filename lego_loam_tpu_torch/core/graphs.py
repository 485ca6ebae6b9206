"""CUDA graphs around the port's fixed-shape chains of small ops.

A scan's odometry is some 1,800 small kernels between a handful of host
reads, and it is the host's launches, not the card, that set its pace.
:func:`run` calls ``fn(*args)``; for CUDA tensors it captures the call as a
CUDA graph once per key and from then on replays it, so that a chain costs
a copy of its inputs (one multi-tensor copy a dtype) and one graph launch.
For CPU tensors it calls ``fn`` directly: the CPU path is the plain eager
code.

The key is what the call site can observe: ``fn``, the structure of the
arguments with every non-tensor among them (a configuration, a flag: their
values enter the captured chain as Python constants, so they must be
hashable), the current stream, and the device, shape, dtype and strides of
every tensor.  Entries are kept per host thread
(``distributed/mesh.py::replay_sharded`` runs one thread a shard, several
on one card): a thread never replays another thread's graph, and its graphs
go when it ends.

A key is captured once, after one eager call on a side stream (cuBLAS and
the caching allocator set up there, outside the capture), in
``thread_local`` capture mode so that other threads go on launching and
reading meanwhile, and one capture at a time in the process.  ``fn`` must
live as long as the process (a fresh closure per call would be captured
anew each time), take as arguments every tensor that changes between calls,
and read nothing on the host.  Device constants it needs come from
:func:`constant`, which makes them in the eager call, before the capture.

The outputs are the graph's own buffers, which the next replay of the same
entry overwrites: a result kept past that is copied out (:func:`owned`).

Arguments may be tensors, ``core.types.Container``s, tuples (named ones
too) and lists of them; anything else is a constant of the key.  :func:`capture_count` and
:func:`replay_count` count captures and replays over the process, as
``core/device.py::sync_count`` counts host reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Sequence

import torch

from .types import Container

Tensor = torch.Tensor

_TENSOR = object()          # a tensor's place in an argument structure
_CONST = object()           # marks a constant of the key

_LOCAL = threading.local()  # .entries, .side: this thread's graphs, streams
_CAPTURE_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_CAPTURES = 0
_REPLAYS = 0
_CONSTANTS: dict = {}


@dataclasses.dataclass
class _Entry:
    replay: Callable[[], None]
    inputs: List[Tensor]     # static inputs, in the order of the leaves
    outputs: object          # fn's outputs, the graph's own buffers


def _flatten(x, leaves: list):
    """The structure of ``x`` (hashable), its tensors appended to
    ``leaves``."""
    if isinstance(x, Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, Container):
        return (type(x), tuple(_flatten(getattr(x, f.name), leaves)
                               for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return (_CONST, x)


def _unflatten(spec, leaves):
    """Inverse of :func:`_flatten`, taking tensors from the iterator
    ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    kind, body = spec
    if kind is _CONST:
        return body
    items = [_unflatten(s, leaves) for s in body]
    if issubclass(kind, Container) or hasattr(kind, "_fields"):
        return kind(*items)          # a dataclass or a NamedTuple
    return kind(items)


def _replayable(t: Tensor) -> bool:
    return t.is_cuda


def _key(fn, spec, leaves: Sequence[Tensor]):
    stream = (torch.cuda.current_stream(leaves[0].device).cuda_stream
              if leaves[0].is_cuda else None)
    return (fn, spec, stream,
            tuple((t.device, t.shape, t.dtype, t.stride()) for t in leaves))


def _entries() -> dict:
    entries = getattr(_LOCAL, "entries", None)
    if entries is None:
        entries = _LOCAL.entries = {}
    return entries


def _side_stream(device: torch.device):
    side = getattr(_LOCAL, "side", None)
    if side is None:
        side = _LOCAL.side = {}
    if device not in side:
        side[device] = torch.cuda.Stream(device=device)
    return side[device]


def _record(fn, spec, static: List[Tensor]):
    """Capture ``fn`` on the static inputs; returns (replay, outputs)."""
    device = static[0].device
    for t in static:
        if t.device != device:
            raise ValueError(f"a captured chain takes tensors of one device, "
                             f"got {t.device} beside {device}")
    with torch.cuda.device(device):
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            fn(*_unflatten(spec, iter(static)))
            with _CAPTURE_LOCK:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = fn(*_unflatten(spec, iter(static)))
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
    return graph.replay, outputs


def run(fn, *args):
    """``fn(*args)``, replayed from a CUDA graph for CUDA tensors (the
    outputs are then the graph's buffers, see the module's docstring)."""
    global _CAPTURES, _REPLAYS
    leaves: List[Tensor] = []
    spec = _flatten(args, leaves)
    if not leaves or not _replayable(leaves[0]):
        return fn(*args)
    entries = _entries()
    key = _key(fn, spec, leaves)
    entry = entries.get(key)
    if entry is None:
        static = [t.clone() for t in leaves]
        replay, outputs = _record(fn, spec, static)
        entry = entries[key] = _Entry(replay, static, outputs)
        with _COUNT_LOCK:
            _CAPTURES += 1
    _copy(entry.inputs, leaves)
    entry.replay()
    with _COUNT_LOCK:
        _REPLAYS += 1
    return entry.outputs


def _copy(dst: Sequence[Tensor], src: Sequence[Tensor]) -> None:
    """``dst[i].copy_(src[i])`` for all i, one multi-tensor copy a dtype."""
    groups: dict = {}
    for d, t in zip(dst, src):
        to, of = groups.setdefault(t.dtype, ([], []))
        to.append(d)
        of.append(t)
    for to, of in groups.values():
        torch._foreach_copy_(to, of)


def owned(tree):
    """``tree`` with every tensor copied: what a caller keeps past the next
    replay of the graph that produced it."""
    leaves: List[Tensor] = []
    spec = _flatten(tree, leaves)
    copies = [torch.empty_like(t) for t in leaves]
    _copy(copies, leaves)
    return _unflatten(spec, iter(copies))


def constant(values, dtype: torch.dtype, device) -> Tensor:
    """A cached tensor of ``values`` on ``device``, made once (outside any
    capture, by the eager call that precedes it) and never written.  The
    first one made stays: a graph reads it by address, and the cache is what
    keeps it alive (threads that make one at once all get the first)."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS.setdefault(
            key, torch.tensor(key[0], dtype=dtype, device=device))
    return t


def capture_count() -> int:
    return _CAPTURES


def replay_count() -> int:
    return _REPLAYS

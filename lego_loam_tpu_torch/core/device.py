"""Device selection and host-synchronisation accounting.

Entry points take ``device=None`` meaning "the CUDA card"; they raise when
there is none instead of carrying on on the CPU.  Tests pass ``"cpu"``.

Every place where the pipeline deliberately reads a device value on the
host (a convergence flag of a Gauss-Newton loop, an "enough points" gate)
goes through :func:`host_bool`, which counts the read: each one is a
stream synchronisation on a CUDA device, and the count per scan is part of
what ``chip_smoke.py`` reports.  The count is exact when several host
threads read at once (``distributed/mesh.py::replay_sharded`` runs one
thread per shard): it is kept under a lock.

:func:`stage` brackets a pipeline stage with a pair of CUDA events when
stage timing has been switched on (:func:`start_stage_timing`); the events
are only read afterwards (:func:`stage_times_ms`), so timing adds no
synchronisation to the run it measures.  Off (the default) and on the CPU it
does nothing.  Timing is keyed by thread: only the thread that switched it
on records stages, so a run with several host threads (whose stages would
interleave on one stream) times nothing in the others.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_SYNCS = 0
_SYNCS_LOCK = threading.Lock()
_STAGES: Optional[List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]] = None
_STAGE_THREAD: Optional[int] = None     # the thread that records stages


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` → ``cuda`` (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present: pass device='cpu' explicitly to "
                "run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def host_bool(flag: torch.Tensor) -> bool:
    """Read a () bool tensor on the host (one counted synchronisation)."""
    global _SYNCS
    with _SYNCS_LOCK:
        _SYNCS += 1
    return bool(flag.item())


def sync_count() -> int:
    return _SYNCS


def reset_sync_count() -> None:
    global _SYNCS
    with _SYNCS_LOCK:
        _SYNCS = 0


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    """Bracket one pipeline stage with CUDA events (when timing is on)."""
    if (_STAGES is None or device.type != "cuda"
            or threading.get_ident() != _STAGE_THREAD):
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        yield
    finally:
        end.record()
        _STAGES.append((name, start, end))


def start_stage_timing() -> None:
    """Record stages from now on, in the calling thread only."""
    global _STAGES, _STAGE_THREAD
    _STAGES = []
    _STAGE_THREAD = threading.get_ident()


def stage_times_ms() -> Dict[str, float]:
    """Synchronise, sum the recorded stage times by name (milliseconds on
    the stream's timeline, host-induced gaps included) and switch timing
    off."""
    global _STAGES, _STAGE_THREAD
    recorded, _STAGES, _STAGE_THREAD = _STAGES or [], None, None
    if recorded:
        torch.cuda.synchronize()
    total: Dict[str, float] = {}
    for name, start, end in recorded:
        total[name] = total.get(name, 0.0) + start.elapsed_time(end)
    return total

"""Device selection and host-synchronisation accounting.

Entry points take ``device=None`` meaning "the CUDA card"; they raise when
there is none instead of carrying on on the CPU.  Tests pass ``"cpu"``.

Every place where the pipeline deliberately reads a device value on the
host (a convergence flag of a Gauss-Newton loop, an "enough points" gate)
goes through :func:`host_bool`, which counts the read: each one is a
stream synchronisation on a CUDA device, and the count per scan is part of
what ``chip_smoke.py`` reports.

:func:`stage` brackets a pipeline stage with a pair of CUDA events when
stage timing has been switched on (:func:`start_stage_timing`); the events
are only read afterwards (:func:`stage_times_ms`), so timing adds no
synchronisation to the run it measures.  Off (the default) and on the CPU it
does nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_SYNCS = 0
_STAGES: Optional[List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]] = None


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
    _SYNCS += 1
    return bool(flag.item())


def sync_count() -> int:
    return _SYNCS


def reset_sync_count() -> None:
    global _SYNCS
    _SYNCS = 0
_STAGES: Optional[List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]] = None


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    """Bracket one pipeline stage with CUDA events (when timing is on)."""
    if _STAGES is None or device.type != "cuda":
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
    global _STAGES
    _STAGES = []


def stage_times_ms() -> Dict[str, float]:
    """Synchronise, sum the recorded stage times by name (milliseconds on
    the stream's timeline, host-induced gaps included) and switch timing
    off."""
    global _STAGES
    recorded, _STAGES = _STAGES or [], None
    if recorded:
        torch.cuda.synchronize()
    total: Dict[str, float] = {}
    for name, start, end in recorded:
        total[name] = total.get(name, 0.0) + start.elapsed_time(end)
    return total

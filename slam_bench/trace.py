"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
steady scans, and recording wrappers around the two hand-written kernels'
launch functions that note each launch's shapes and valid counts.

The wrappers add no host read: K2's valid pairs are summed on the device
and read once when the slice ends.  What the slice yields is plain data
(seconds, counts, names) that the metric readers under
``slam_bench/metrics/`` reduce.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

from .metrics._arith import k2_bytes

_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class KernelRecorder:
    """Wraps ``cuda_label.propagate_labels_cuda`` and
    ``cuda_knn.knn5_cuda_grouped`` (module attributes, which the program's
    callers look up at call time) while active."""

    def __init__(self):
        self.k1_pixels: List[int] = []
        self.k2_bytes: List[int] = []
        self.k2_pairs: List[torch.Tensor] = []

    def __enter__(self):
        from lego_loam_tpu_torch.frontend import cuda_label
        from lego_loam_tpu_torch.match import cuda_knn
        self._mods = (cuda_label, cuda_knn)
        self._orig = (cuda_label.propagate_labels_cuda,
                      cuda_knn.knn5_cuda_grouped)
        label, knn = self._orig

        def recording_label(labels0, right, down):
            self.k1_pixels.append(labels0.numel())
            return label(labels0, right, down)

        def recording_knn(problems):
            n_bytes = 0
            pairs = None
            for q, qv, c, cv in problems:
                n_bytes += k2_bytes(q.shape[0], c.shape[0])
                p = (qv.sum(dtype=torch.int64) * cv.sum(dtype=torch.int64))
                pairs = p if pairs is None else pairs + p
            self.k2_bytes.append(n_bytes)
            self.k2_pairs.append(pairs)
            return knn(problems)

        cuda_label.propagate_labels_cuda = recording_label
        cuda_knn.knn5_cuda_grouped = recording_knn
        return self

    def __exit__(self, *exc):
        cuda_label, cuda_knn = self._mods
        cuda_label.propagate_labels_cuda, cuda_knn.knn5_cuda_grouped = \
            self._orig
        return False

    def summary(self) -> Dict:
        pairs = ([int(v) for v in torch.stack(self.k2_pairs).cpu()]
                 if self.k2_pairs else [])
        return {"k1_pixels": list(self.k1_pixels),
                "k2_bytes": list(self.k2_bytes), "k2_pairs": pairs}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce_events(events, t0_us: float, t1_us: float) -> Dict:
    """Device busy time, kernel launches, device time by kernel name and
    idle time by what the host was running, from profiler events
    (``FunctionEvent``s with ``device_type``, ``time_range``, ``name``,
    ``thread``) inside [t0_us, t1_us].  The host ops are those of the
    thread that issued the most (the one driving the pipeline)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t < t0_us or s > t1_us:
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append((max(s, t0_us), min(t, t1_us), e.name))
        elif (e.device_type == DeviceType.CPU
              and not getattr(e, "is_async", False)):
            cpu.append((s, t, e.name, e.thread))
    if cpu:
        main = collections.Counter(c[3] for c in cpu).most_common(1)[0][0]
        cpu = [c[:3] for c in cpu if c[3] == main]
    busy = _union([(s, t) for s, t, _ in dev])
    by_name: Dict[str, float] = collections.Counter()
    launches = 0
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
        if not name.startswith(_COPY_PREFIXES):
            launches += 1
    # idle gaps, each named by the innermost host op running at its middle
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = collections.Counter()
    edges = [t0_us] + [x for iv in busy for x in iv] + [t1_us]
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "host: no op (Python)"
        i = bisect.bisect_right(starts, mid) - 1
        for back in range(i, max(-1, i - 256), -1):
            if cpu[back][1] >= mid:
                name = cpu[back][2]
                break
        gaps[name] += (g1 - g0) * 1e-6
    return {
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "launches": launches,
        "device_s_by_name": dict(by_name),
        "idle_s_by_host_op": dict(gaps),
    }


class ProfiledSlice:
    """``torch.profiler`` (CPU and CUDA activities) over a block of scans
    that starts and ends with ``torch.cuda.synchronize()``, plus the
    kernel recorder."""

    def __init__(self, device: torch.device):
        self.device = device
        self.result: Dict = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        sync(self.device)
        self.recorder = KernelRecorder().__enter__()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self.recorder.__exit__(*exc)
        return False

    def reduce(self) -> None:
        """Read the trace into ``result``; called once the measured window
        has closed, so that the reading takes none of its time."""
        events = self.prof.events()
        # the profiled range on the trace's own clock: first to last event
        spans = [(e.time_range.start, e.time_range.end) for e in events]
        t0 = min(s for s, _ in spans) if spans else 0.0
        t1 = max(t for _, t in spans) if spans else 0.0
        red = reduce_events(events, t0, t1)
        self.result = {"window_s": self.window_s,
                       "trace_s": (t1 - t0) * 1e-6,
                       **red, **self.recorder.summary()}

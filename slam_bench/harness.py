"""One run of one benchmark cell: inputs from the seed, warm-up, the measured
window, the check against the plain reference, the metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
is data found by name (``slam_bench/configs/<config>.json``,
``slam_bench/traffic/<mix>.json``, ``slam_bench/workloads/<cell>.json``,
``slam_bench/metrics/<metric>.py``), listed in ``BENCHMARK.json``.  The
program measured is ``lego_loam_tpu_torch``; of it the harness uses the
configuration, the per-scan step (``pipeline/slam.py::slam_step`` and the
``replay`` around it), the live feed (``io/native_feeder.py``), and the
program's own counters and stage events (``core/device.py``).

A traffic mix is driven by one of two loops:

- ``replay``: closed loop, as ``run.main`` replays offline: the sweeps sit
  on the device, one ``slam_step`` a scan from a fresh state, for
  ``--seconds``; the window ends in ``torch.cuda.synchronize()``.
- ``live``: open loop at the sensor's rate: a producer thread sends sweep i
  (a host buffer, as a sensor driver delivers it) at ``t0 + i * period``
  into ``ScanChannel`` (depth 1); the consumer runs ``run.stream``'s loop
  (``DeviceFeed.recv`` -> ``slam_step`` -> fused pose read on the host).
  A scan's latency runs from its due time to that read, so a send that
  waits on a full channel counts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .capture import StageRecorder
from .gen.scans import Sweeps, pack
from .gen.world import Circle, world_for
from .reference import stages, truth
from .trace import ProfiledSlice, sync

PKG = Path(__file__).resolve().parent
REPO = PKG.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = REPO, spec: Optional[Dict] = None):
        self.root = Path(root)
        self.spec = (spec if spec is not None
                     else load_json(self.root / "BENCHMARK.json"))
        self.dir = self.root / PKG.name

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r}; the cells are "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> Dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def workload(self, name: str) -> Dict:
        return load_json(self.dir / "workloads" / f"{name}.json")

    def metrics_for(self, cell: str, traced: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``traced`` false) or per-layer
        metrics (true): those that list the cell, or, without a
        ``workloads`` key, every cell that reports what they move."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PKG.name}_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def build_config(spec: Dict):
    """The program's configuration as the file states it: the named
    factory's, with every value the file gives (a key the program lacks
    raises)."""
    from lego_loam_tpu_torch.core import config as C
    base = getattr(C, spec["factory"])()
    sections = {}
    for name, values in spec["config"].items():
        sec = getattr(base, name)
        have = {f.name for f in dataclasses.fields(sec)}
        unknown = set(values) - have
        if unknown:
            raise KeyError(f"{name}: the program has no {sorted(unknown)}")
        sections[name] = dataclasses.replace(sec, **{
            k: tuple(v) if isinstance(getattr(sec, k), tuple) else v
            for k, v in values.items()})
    return dataclasses.replace(base, **sections)


@dataclasses.dataclass
class Inputs:
    """The cell's sweeps: ``K`` noised laps of ``L`` scans each; scan i of
    the stream is lap (i // L) mod K's scan i mod L, stamped i * period."""

    circle: Circle
    K: int
    xyz: torch.Tensor                  # (K*L, cap*3) on the device
    valid: torch.Tensor                # (K*L, cap)
    host: Optional[np.ndarray]         # (K*L, P, 3) float32, NaN for misses,
    #                                    live mixes only
    stamps: torch.Tensor               # (n,) float32 on the device

    @property
    def L(self) -> int:
        return self.circle.scans_per_lap

    @property
    def period(self) -> float:
        return self.circle.period

    def row(self, i: int) -> int:
        return (i // self.L) % self.K * self.L + i % self.L


def make_inputs(laser: Dict, traffic: Dict, cfg, seed: int,
                device: torch.device) -> Inputs:
    """Raycast one lap through the mix's world (``world_seed``: the campus
    a deployment drives, the same in every run) on ``device`` and noise
    ``noised_laps`` laps of it from ``seed``; replay mixes keep them packed
    on the device, live mixes as host buffers too (what the sensor driver
    hands over)."""
    tr = traffic["trajectory"]
    circle = Circle(radius=float(tr["radius_m"]),
                    scans_per_lap=int(tr["scans_per_lap"]),
                    period=float(laser["scan_period"]),
                    height=float(tr["height_m"]))
    sweeps = Sweeps(laser, circle,
                    world_for(int(traffic["world_seed"]), circle), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    K = int(traffic["noised_laps"])
    cap = cfg.pipeline.max_points
    xyz, valid, host = [], [], []
    for _ in range(K):
        pts = sweeps.points(float(traffic["noise_m"]), gen)
        if traffic["mode"] == "live":
            host.append(pts.cpu().numpy())
        x, v = pack(pts, cap)
        xyz.append(x)
        valid.append(v)
        del pts
    n_stamps = int(traffic.get("max_scans", 100000))
    stamps = torch.as_tensor(
        (np.arange(n_stamps) * circle.period).astype(np.float32),
        device=device)
    return Inputs(circle=circle, K=K, xyz=torch.cat(xyz),
                  valid=torch.cat(valid),
                  host=np.concatenate(host) if host else None, stamps=stamps)


def replay_rows(inp: Inputs, n: int, cfg, device):
    """The program's offline ``replay`` of the stream's first ``n`` scans
    from a fresh state."""
    from lego_loam_tpu_torch.pipeline.slam import replay
    rows = torch.as_tensor([inp.row(i) for i in range(n)], device=device)
    return replay(inp.xyz[rows], inp.valid[rows], inp.stamps[:n], cfg,
                  device=device)


def warm_up(inp: Inputs, traffic: Dict, cfg, device: torch.device) -> None:
    """A throwaway state through the cell's first scans, then each shape
    that a later scan of the cell can first meet: K2 at the loop ICP's
    shape, the pose-graph re-solve and the grid rebuild; for a live mix
    the native channel and the pinned feed."""
    from lego_loam_tpu_torch.graph import posegraph, submap_grid
    from lego_loam_tpu_torch.match import cuda_knn

    state, _ = replay_rows(inp, int(traffic["warmup_scans"]), cfg, device)
    m = cfg.mapping
    g = torch.Generator(device=device)
    g.manual_seed(0)
    q = torch.rand((m.loop_source_cap, 3), device=device, generator=g)
    c = torch.rand((m.loop_history_cap, 3), device=device, generator=g)
    cuda_knn.knn5(q, torch.ones(q.shape[0], dtype=torch.bool, device=device),
                  c, torch.ones(c.shape[0], dtype=torch.bool, device=device))
    meta = state.mapping.meta
    if m.enable_loop_closure:
        poses, _ = posegraph.optimize_poses(meta.kf_pose, meta.kf_count,
                                            meta.graph, gn_iters=3,
                                            pcg_iters=64, return_iters=True)
        submap_grid.rebuild(poses, meta.kf_count, state.mapping.clouds, cfg,
                            window=m.surrounding_keyframe_search_num)
    if traffic["mode"] == "live":
        from lego_loam_tpu_torch.io.native_feeder import DeviceFeed, ScanChannel
        channel = ScanChannel(cfg.pipeline.max_points, depth=1)
        feed = DeviceFeed(channel, device)
        for i in range(2):
            channel.send(inp.host[inp.row(i)], float(inp.stamps[i]))
            feed.recv()
        channel.close()
    sync(device)


class StageClock:
    """The program's stage events and host-read counter over the timed
    scans, with the profiled slice left out."""

    def __init__(self, on: bool):
        from lego_loam_tpu_torch.core import device as D
        self.D, self.on = D, on
        self.ms: Dict[str, float] = {}
        self.reads = 0
        self._reads0 = D.sync_count()
        if on:
            D.start_stage_timing()

    def pause(self) -> None:
        self.reads += self.D.sync_count() - self._reads0
        if self.on:
            for k, v in self.D.stage_times_ms().items():
                self.ms[k] = self.ms.get(k, 0.0) + v

    def resume(self) -> None:
        self._reads0 = self.D.sync_count()
        if self.on:
            self.D.start_stage_timing()


def _mapping_scans(first: int, n: int, divider: int) -> int:
    return sum(1 for i in range(first, first + n)
               if i % divider == divider - 1)


def sample_scans(seed: int, first: int, check: Dict, divider: int) -> set:
    """The window's scans (counted from its start) whose stages the stage
    reference judges: ``check["scans"]`` mapping-cycle scans drawn from the
    seed among the window's first ``check["among"]``, so that every stage,
    K2 included, runs on each."""
    cands = [k for k in range(int(check["among"]))
             if (first + k) % divider == divider - 1]
    rng = np.random.default_rng([seed % (1 << 63), 0x5CA7])
    n = min(int(check["scans"]), len(cands))
    return {int(k) for k in rng.choice(cands, size=n, replace=False)}


def replay_window(state, inp: Inputs, cfg, device, first: int,
                  seconds: float, trace: Optional[Dict], marked: set,
                  recorder: StageRecorder, check_scans: int):
    """Closed-loop replay from scan ``first`` for ``seconds``; the stages of
    the ``marked`` scans go to ``recorder``.  The check judges the stream's
    first ``check_scans`` scans whatever the host's speed: where the window
    served fewer, the same loop serves the rest once it has closed,
    untimed."""
    from lego_loam_tpu_torch.core.types import RawScan
    from lego_loam_tpu_torch.pipeline.slam import slam_step

    clock = StageClock(trace is not None)
    sl_first = first + trace["first_scan"] if trace else -1
    sl_end = sl_first + trace["scans"] if trace else -1
    profile, fused, diag, marks = None, [], [], []
    i = first
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    # a traced run measures no end-to-end metric: it runs on past the
    # deadline until its profiled slice is done
    while time.perf_counter() < deadline or i < sl_end:
        if (i - first) % 50 == 0:
            marks.append(time.perf_counter())
        recorder.mark(i - first in marked)
        if i == sl_first:
            clock.pause()
            profile = ProfiledSlice(device).__enter__()
        r = inp.row(i)
        raw = RawScan(xyz=inp.xyz[r].reshape(-1, 3), valid=inp.valid[r],
                      stamp=inp.stamps[i])
        state, out = slam_step(state, raw, cfg, device=device)
        fused.append(out["fused"])
        diag.append(out["loop_diag"])
        i += 1
        if i == sl_end:
            profile.__exit__(None, None, None)
            clock.resume()
    sync(device)
    window_s = time.perf_counter() - t0
    clock.pause()
    n = i - first
    while i - first < check_scans:
        recorder.mark(i - first in marked)
        r = inp.row(i)
        raw = RawScan(xyz=inp.xyz[r].reshape(-1, 3), valid=inp.valid[r],
                      stamp=inp.stamps[i])
        state, out = slam_step(state, raw, cfg, device=device)
        fused.append(out["fused"])
        diag.append(out["loop_diag"])
        i += 1
    recorder.mark(False)
    rec = {"window_s": window_s, "scans": n, "attempted": n,
           # scans a second over each stretch of 50 (the host's clock): how
           # steady the rate is within the run
           "chunk_scans_per_s": [50.0 / (b - a)
                                 for a, b in zip(marks, marks[1:])],
           "fused": torch.stack(fused).cpu().numpy(),
           "loop_diag": torch.stack(diag).cpu().numpy()}
    _stage_records(rec, clock, cfg, first, n, profile, trace)
    return state, rec


def live_window(state, inp: Inputs, cfg, device, first: int, n: int,
                trace: Optional[Dict], marked: set, recorder: StageRecorder):
    """Open loop at the sensor's rate over scans ``first`` .. ``first+n-1``;
    the stages of the ``marked`` scans go to ``recorder``."""
    from lego_loam_tpu_torch.io.native_feeder import DeviceFeed, ScanChannel
    from lego_loam_tpu_torch.pipeline.slam import slam_step

    period = inp.period
    channel = ScanChannel(cfg.pipeline.max_points, depth=1)
    feed = DeviceFeed(channel, device)
    due = np.zeros(n)
    woke = np.full(n, np.nan)
    done = np.full(n, np.nan)
    fused = np.full((n, 6), np.nan)
    diag = []
    stamps = inp.stamps[first:first + n].cpu().numpy()
    buffers = [inp.host[inp.row(first + k)] for k in range(n)]
    clock = StageClock(trace is not None)
    sl_first = trace["first_scan"] if trace else -1
    sl_end = sl_first + trace["scans"] if trace else -1
    profile = None
    t0 = time.perf_counter() + 0.05
    due[:] = t0 + np.arange(n) * period

    def produce():
        try:
            for k in range(n):
                wait = due[k] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                woke[k] = time.perf_counter()
                if not channel.send(buffers[k], float(stamps[k])):
                    return
        finally:
            channel.close()

    producer = threading.Thread(target=produce, name="sensor", daemon=True)
    producer.start()
    got = 0
    try:
        for k in range(n):
            if k == sl_first:
                clock.pause()
                profile = ProfiledSlice(device).__enter__()
            raw = feed.recv()
            if raw is None:
                break
            recorder.mark(k in marked)
            state, out = slam_step(state, raw, cfg, device=device)
            fused[k] = out["fused"].cpu().numpy()     # the pose a user reads
            diag.append(out["loop_diag"])
            done[k] = time.perf_counter()
            got = k + 1
            if k + 1 == sl_end:
                profile.__exit__(None, None, None)
                clock.resume()
    finally:
        recorder.mark(False)
        channel.close()
        producer.join(timeout=60.0)
    if producer.is_alive():
        raise RuntimeError("the sensor thread did not stop")
    sync(device)
    clock.pause()
    rec = {"window_s": float(done[got - 1] - due[0]) if got else 0.0,
           "scans": got, "attempted": n, "fused": fused[:got],
           "loop_diag": (torch.stack(diag).cpu().numpy() if diag
                         else np.zeros((0, 8))),
           "latency_ms": list(1e3 * (done[:got] - due[:got])),
           "sensor_late_ms": list(1e3 * (woke - due))}
    _stage_records(rec, clock, cfg, first, got, profile, trace)
    return state, rec


def _stage_records(rec: Dict, clock: StageClock, cfg, first: int, n: int,
                   profile, trace: Optional[Dict]) -> None:
    div = cfg.mapping.mapping_frequency_divider
    sliced = (trace["first_scan"], trace["scans"]) if profile else (0, 0)
    timed = n - sliced[1]
    cycles = (_mapping_scans(first, n, div)
              - _mapping_scans(first + sliced[0], sliced[1], div))
    rec["host_reads"] = clock.reads
    rec["timed_scans"] = timed
    if clock.on:
        rec["stage_ms"] = dict(clock.ms)
        rec["mapping_cycles"] = cycles
    if profile is not None:
        profile.reduce()
        rec["profile"] = {**profile.result, "scans": sliced[1]}


def program_outputs(state) -> Dict[str, np.ndarray]:
    """What the reference judges besides the served poses: the factor
    graph, the keyframe stamps and the saturation counters."""
    meta = state.mapping.meta
    nf, nk = int(meta.factor_count), int(meta.kf_count)
    g = meta.graph
    return {"i": g.i[:nf].cpu().numpy(), "j": g.j[:nf].cpu().numpy(),
            "z": g.z[:nf].cpu().numpy(),
            "kf_stamp": meta.kf_stamp[:nk].cpu().numpy(),
            "kf_dropped": int(meta.kf_dropped),
            "factor_dropped": int(meta.factor_dropped),
            "map_sat": int(meta.map_sat)}


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             adjust: Optional[Callable] = None) -> Dict:
    """One run; returns the result's fields, the records the metric readers
    take and the outputs the reference judged.  ``t_start``:
    ``time.perf_counter()`` when the process started; ``adjust``: a
    function of the configuration as the file states it that returns the
    one to run (the controls' and faults' readings only)."""
    from lego_loam_tpu_torch.pipeline.slam import init_state

    cell = bench.cell(cell_name)
    cfg_spec = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    work = bench.workload(cell_name)
    cfg = build_config(cfg_spec)
    if adjust is not None:
        cfg = adjust(cfg)
    laser = cfg_spec["config"]["laser"]
    trace = work["trace"] if traced else None

    inp = make_inputs(laser, traffic, cfg, seed, device)
    warm_up(inp, traffic, cfg, device)
    first = int(traffic["setup_laps"]) * inp.L
    if first:
        state, _ = replay_rows(inp, first, cfg, device)
    else:
        state = init_state(cfg, device)
    marked = sample_scans(seed, first, work["stage_check"],
                          cfg.mapping.mapping_frequency_divider)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # what set-up left behind moves to the collector's permanent generation,
    # so that a collection inside the window does not walk it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    try:
        with StageRecorder() as recorder:
            if traffic["mode"] == "replay":
                state, rec = replay_window(state, inp, cfg, device, first,
                                           seconds, trace, marked, recorder,
                                           int(work["check_scans"]))
            else:
                n = int(round(seconds / inp.period))
                state, rec = live_window(state, inp, cfg, device, first, n,
                                         trace, marked, recorder)
    finally:
        gc.unfreeze()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    outs = {"fused": rec.pop("fused"), **program_outputs(state)}
    loop_diag = rec.pop("loop_diag")
    circle = inp.circle
    del state, inp
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = truth.numbers(outs, circle.pose_at, circle.period, first)
    values.update(stages.numbers(recorder.records))
    del recorder
    # what the window's loop attempts did (printed beside the numbers; the
    # check reads the factors themselves)
    values["loop_attempts"] = float((loop_diag[:, 0] > 0).sum())
    values["loop_accepted"] = float((loop_diag[:, 1] > 0).sum())
    values["loop_resolves"] = float((loop_diag[:, 7] > 0).sum())
    correct, checks = truth.judge(values, work["limits"])
    failed = int(values["nonfinite_poses"]) + rec["attempted"] - rec["scans"]
    rec.update({"setup_s": setup_s, "mode": traffic["mode"],
                "device_kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu")})
    metrics = {}
    for m in bench.metrics_for(cell_name, traced):
        v = bench.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"correct": correct and failed == 0,
            "attempted": rec["attempted"], "failed": failed,
            "metrics": metrics, "memory_peak_bytes": memory_peak,
            "checks": checks, "values": values, "records": rec,
            "outputs": {**outs, "loop_diag": loop_diag, "first": first}}

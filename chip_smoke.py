#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scans N] [--long]

Needs one CUDA card, ``nvcc`` and nothing else; exits non-zero without a
card.  The synthetic sequences it replays are made on the host in worker
processes from the start, beside the kernel phases.  It

1. prints the card (``nvidia-smi`` name and power limit) and the versions,
2. builds the hand-written kernels from ``lego_loam_tpu_torch/csrc``,
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the pipeline gives it and a few harder ones (label images of 1 to
   128 rows, so that every cluster size and the tiled kernel run; the
   grouped 5-NN call against the plain version and against single calls,
   repeated calls against each other, each wrapper replayed from a CUDA
   graph against its eager result), and times kernel, plain version and
   (where one exists) a library call,
4. replays a small sequence on the card and on the CPU and compares them,
5. drives the main paths, each with the launch counts (and the host-read,
   ICP-iteration and re-solve counts) set to zero just before and read just
   after, and checks each trajectory against ground truth:
   ``slice`` — ``pipeline.slam.replay`` of a synthetic VLP-16 sequence at
   full width with loop closure off; ``loop`` — the default ``vlp16()``
   (loop closure ON) on one 31.4 s lap, which closes loops, so detection,
   ICP (K2 at 4096 x 32768), the pose-graph solver and the grid rebuild
   run,
6. ``resolve``: one pose-graph re-solve and grid rebuild on the loop run's
   final graph, timed; the solve must not raise the graph's residual,
   ``stage1_graphs``: the loop lap's first 100 scans through stage 1 alone,
   its two chains replayed from CUDA graphs around the eager K1 launch and
   called eagerly, bit-equal scan by scan, with the runner's captures and
   replays, ms a scan and the device time a scan of each side,
   ``stage2_graphs``: the loop lap's first 100 scans through stage 2 alone,
   its chains replayed from CUDA graphs (``core/graphs.py``) and called
   eagerly, bit-equal scan by scan, with the runner's captures and replays,
   ``stage3_graphs``: the same scans' mapping cycles (``vlp16()``, loop
   closure on) graphed and eager from states of their own, bit-equal cycle
   by cycle, with ms a cycle, K2's problems and the replays a cycle,
   ``loop_parity``: a small loop-closing lap twice on the card and once on
   the CPU — the two card runs bit-equal in every output and state field
   (``determinism``), card and CPU keyframe and loop-factor counts equal,
   fused poses within 0.1 m,
7. ``cli``: ``python -m lego_loam_tpu_torch.run`` (its ``main``) on an
   ``.npz`` of the slice's sequence, on the card; every artifact written;
   then on a ROS1 ``.bag`` of the same scans (``io/rosbag.py``), whose
   counts, keyframe poses and trajectories must equal the ``.npz`` run's,
   ``streaming``: the live mode (``run.stream``: native channel, pinned
   double buffer, one ``slam_step`` a scan) on the same scans with
   ``vlp16()``: latency per scan against the sensor's 100 ms, the fused
   trajectory bit-equal to ``replay``'s, and the pinned feed checked scan
   by scan; ``odometry``: ``BASELINE.json`` config 3 (odometry only, no
   K2); ``multisession``: config 5, ``benchmarks/multi_session.py``'s two
   sessions (314 + 200 scans) whole and split at a checkpoint, the split
   bit-equal,
8. ``hdl64``: ``hdl64()`` as shipped (KITTI geometry, 64 x 2083 image,
   loop closure on, banded search off) on the 330-scan drive of
   ``benchmarks/kitti64_drive.py``, whose 314-scan lap closes a loop; its
   scans are made in chunks by the worker processes beside the others,
   ``banded``: the first 120 scans of that drive with the banded odometry
   search on (``odom_band_rings=4``, the pick caps its layout needs) and,
   in the same call, off,
9. ``batched``: ``pipeline.slam.batched_replay`` of 4 streams of 100
   scans lock-step (``vlp16()`` as shipped; stream 0 is the slice's
   sequence, seeds 43-45 the others, made in the worker pool), one batched
   K1 launch a scan-step for all 4 images, beside ``replay`` of stream 0
   alone: aggregate and single-stream scans/s, per-stream ATE,
   ``sharded``: ``distributed.mesh.replay_sharded`` on a mesh of 2 shards on
   the one card (two host threads) over the first 60 scans of those
   streams against the batched run, K2 from two threads on two CUDA
   streams against single calls, ``optimize_poses_sharded`` on the loop
   run's final graph on meshes of 1 and 2 shards, ``replay(mesh=…)`` on
   the small lap over 16 shards with a re-solve at every closure, each
   re-solve held to ``optimize_poses`` on its own input graph and the
   keyframe blocks, row-sharded over the mesh, reassembled bit-equal to the
   run without a mesh, and ``replay(mesh=…)`` of the ``loop`` lap over 4
   shards (every card in turn, or the one card 4 times) bit-equal to the
   ``loop`` run in every output and state field, each shard holding exactly
   its rows, ``multihost``: the ``torch.distributed`` worker
   (``distributed/multihost.py``) in 2 processes over ``gloo`` on the card
   and in 1 process over ``nccl``, each held to the single-device solve, to
   each stream's own replay, and, for its ``replay`` over the global mesh
   (a keyframe row on every shard), to a one-process replay bit for bit,
   every partial sum counted through the backend's ``all_reduce``,
10. with ``--long``, ``stevens`` (``BASELINE.json`` config 2 at
   ``benchmarks/stevens_stress.py``'s default: the figure-eight tiled to
   2000 scans; then again over a mesh of 4 shards, held to the first run's
   counts and ATE) and ``scaling`` (``multihost --bench`` in 1 and 2
   processes beside two threads),
11. prints one ``{"kernels": [...]}`` line (``launches``: every main path)
   and, last, the ``{"ok": ...}`` line.

Every phase raises on failure; nothing is caught and skipped.  A kernel
gets two times: ``ms``, the device time of one launch (``DEVICE_LAUNCHES``
launches between one pair of CUDA events, once launched eagerly and once
replayed from a CUDA graph; the smaller of the two per-launch times, since
the eager loop cannot go below the host's enqueue rate), and ``call_ms``,
one eager wrapper call between a pair of events (what a caller that waits
for the result pays, enqueue included).  ``launch_floor_ms`` holds the same
times for an empty kernel.  ``plain_ms`` and ``library_ms`` are per-call
times.  ``bound_ms`` is the larger of bytes / peak bandwidth and
operations / peak float32 rate (outside the tensor cores), with the
benchmark's counts (``slam_bench/metrics/_arith.py``) and the published
peaks of an H100 SXM at its full power limit (``slam_bench/peaks.py``).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from slam_bench.metrics._arith import (k1_bytes, k1_ops, k2_bytes, k2_flops,
                                       least_s)
from slam_bench.peaks import PEAKS

H100 = PEAKS["NVIDIA H100 80GB HBM3"]
FAR = 1e30
PLAIN_RANK_TOL = 2e-3      # m^2, see check_knn
TIME_KEYS = ("ms", "ms_loop", "ms_graph", "call_ms")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


DEVICE_LAUNCHES = 100      # launches between one pair of events


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ONE eager call of ``fn()`` in milliseconds:
    for a kernel of a few microseconds this is the wrapper's enqueue cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _events_ms(run, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_capture_stream = None


def capture(fn, *args):
    """``fn(*args)`` captured in a CUDA graph on one side stream, after a
    call on that stream (the 5-NN wrapper keeps its scratch per stream and
    makes it outside a capture).  Returns (graph, captured outputs)."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(*args)
    return graph, out


def device_ms(fn, n: int = DEVICE_LAUNCHES, reps: int = 5) -> dict:
    """Device time of one launch of ``fn()`` on inputs already resident:
    ``n`` launches between one pair of events, divided by ``n`` — launched
    eagerly (``ms_loop``; bounded below by the host's enqueue rate) and
    captured once in a CUDA graph and replayed (``ms_graph``; no host work
    between launches).  ``ms`` is the smaller."""
    def loop():
        for _ in range(n):
            fn()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms_loop = _events_ms(loop, reps) / n
    graph, _ = capture(loop)
    graph.replay()
    torch.cuda.synchronize()
    ms_graph = _events_ms(graph.replay, reps) / n
    del graph
    return {"ms": min(ms_loop, ms_graph), "ms_loop": ms_loop,
            "ms_graph": ms_graph, "launches_timed": n}


def timed(fn) -> dict:
    """``device_ms`` of ``fn`` plus ``call_ms``, one eager call."""
    out = device_ms(fn)
    out["call_ms"] = time_ms(fn)
    return out


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return card


def launch_floor_phase() -> dict:
    """What one launch of an empty kernel costs through the ctypes route."""
    from lego_loam_tpu_torch import kernels
    noop = kernels.lib().noop_launch

    def fn():
        err = noop(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"noop launch failed: CUDA error {err}")
    floor = timed(fn)
    emit({"phase": "launch_floor", "kernel": "noop (csrc/noop.cu)", **floor})
    return floor


# --------------------------------------------------------------------------
# phase 2: torch semantics the port's layout relies on
# --------------------------------------------------------------------------

def semantics_phase(dev) -> None:
    """argmin/argmax/min return the FIRST extremum and sort is stable on
    this device — candidate order downstream depends on both."""
    z = torch.zeros((7, 5000), device=dev)
    assert int(torch.argmax(z[0])) == 0 and int(torch.argmin(z[0])) == 0
    assert torch.all(torch.argmax(z, dim=-1) == 0)
    assert torch.all(torch.argmin(z, dim=-1) == 0)
    assert torch.all(torch.min(z, dim=-1).indices == 0)
    z[:, 1234] = -1.0
    z[:, 4321] = -1.0
    assert torch.all(torch.min(z, dim=-1).indices == 1234)
    assert torch.all(torch.argmax(-z, dim=-1) == 1234)
    key = torch.arange(100000, device=dev) % 7
    order = torch.sort(key, stable=True).indices
    same = key[order][1:] == key[order][:-1]
    assert torch.all(order[1:][same] > order[:-1][same])
    emit({"phase": "semantics", "first_extremum": True, "stable_sort": True})


def flat(result):
    """Tensors of a wrapper's result, whatever its nesting."""
    if isinstance(result, torch.Tensor):
        return [result]
    return [t for part in result for t in flat(part)]


def capture_check(name, fn, first, second) -> None:
    """``fn(*inputs)`` captured in a CUDA graph on the contents of ``first``
    (after a warm-up call) and replayed on the contents of ``second``,
    copied into the same tensors, must equal the eager call on ``second``."""
    static = [t.clone() for t in first]
    graph, captured = capture(fn, *static)
    for dst, src in zip(static, second):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = fn(*second)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(flat(captured), flat(eager))):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: graph replay != eager call "
                                 f"(output {k})")


def kernel_resources(*names):
    """Registers and spill bytes of the kernels whose (mangled) entry name
    contains one of ``names``, from the verbose build's ptxas output."""
    import re
    from lego_loam_tpu_torch import kernels
    found, entry = {}, None
    for log in kernels.build_logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = next((n for n in names if n in m.group(1)), None)
                if entry:
                    found.setdefault(entry, {"registers": 0, "spill_bytes": 0})
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                found[entry]["spill_bytes"] = max(
                    found[entry]["spill_bytes"],
                    int(m.group(1)) + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:        # the most over a kernel's template instances
                found[entry]["registers"] = max(found[entry]["registers"],
                                                int(m.group(1)))
    return found


# --------------------------------------------------------------------------
# phase 3a: K1, connected-component labels
# --------------------------------------------------------------------------

def label_inputs(segmentable, right, down):
    """Kernel inputs from bool masks; edges only join segmentable pixels."""
    from lego_loam_tpu_torch.frontend.cuda_label import SENTINEL
    V, H = segmentable.shape
    right = right & segmentable & torch.roll(segmentable, -1, dims=1)
    down = down.clone()
    down[:-1] &= segmentable[:-1] & segmentable[1:]
    down[-1] = False
    flat = torch.arange(V * H, dtype=torch.int32,
                        device=segmentable.device).reshape(V, H)
    labels0 = torch.where(segmentable, flat, SENTINEL)
    return labels0.contiguous(), right.contiguous(), down.contiguous()


def scan_label_inputs(points, cfg, dev):
    """Edge masks of one synthetic scan, as the pipeline computes them."""
    from lego_loam_tpu_torch.frontend.projection import project_scan
    from lego_loam_tpu_torch.frontend.segmentation import _edge_masks
    from lego_loam_tpu_torch.io.npz_io import pack_raw_scan
    raw = pack_raw_scan(points, 0.0, cfg.pipeline.max_points, device=dev)
    segmentable, right, down = _edge_masks(project_scan(raw, cfg), cfg)
    return label_inputs(segmentable, right, down)


def hand_made_label_cases(V, H, dev):
    full = torch.ones((V, H), dtype=torch.bool, device=dev)
    none = torch.zeros((V, H), dtype=torch.bool, device=dev)
    cases = {}
    # one component across the wrap column, another elsewhere
    seg = none.clone()
    seg[4, H - 6:] = True
    seg[4, :5] = True
    seg[9, 100:140] = True
    cases["wrap"] = label_inputs(seg, full, full)
    # full even rows joined by single pixels at alternating ends: one
    # component whose minimum label travels down every row in turn
    seg = none.clone()
    for i in range(0, V, 2):
        seg[i, 20:H - 20] = True
    for i in range(1, V - 1, 2):
        seg[i, H - 21 if i % 4 == 1 else 20] = True
    cases["serpentine"] = label_inputs(seg, full, full)
    cases["empty"] = label_inputs(none, full, full)
    # every pixel one component through the wrap edges only
    right = none.clone()
    right[:, H - 1] = True
    right[:, : H // 2] = True
    right[:, H // 2 + 1:] = True
    down = none.clone()
    down[:, H - 1] = True
    cases["all_one"] = label_inputs(full, right, down)
    return cases


TILED_IMAGE = (128, 4096)   # too large for 8 bands of shared memory


def label_phase(scans, cfg, dev, floor):
    from lego_loam_tpu_torch.core.config import hdl64
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.synthetic import make_sequence

    V, H = cfg.laser.image_size
    gen = torch.Generator(device="cpu").manual_seed(11)

    def random_case(rows, cols):
        rnd = lambda p: (torch.rand((rows, cols), generator=gen) < p).to(dev)
        return label_inputs(rnd(0.8), rnd(0.45), rnd(0.45))

    cases = {}
    scan_keys = [f"scan{k}" for k in (0, len(scans) // 4, len(scans) // 2,
                                      len(scans) - 1)]
    for key in scan_keys:
        cases[key] = scan_label_inputs(scans[int(key[4:])], cfg, dev)
    cases.update(hand_made_label_cases(V, H, dev))
    big = hdl64()
    big_scans, _, _ = make_sequence(1, big, seed=7, noise=0.01)
    cases["hdl64_scan"] = scan_label_inputs(big_scans[0], big, dev)
    Vb, Hb = big.laser.image_size
    cases["hdl64_random"] = random_case(Vb, Hb)
    # images of fewer than 8 rows: clusters of 1, 2 and 4 blocks
    for rows in (1, 2, 4):
        cases[f"rows{rows}_random"] = random_case(rows, H)
    # an image whose bands do not fit a cluster's shared memory: the size
    # rule sends it to the tiled kernel (tiles of 2 rows here, so every
    # second row border is joined in global memory)
    Vt, Ht = TILED_IMAGE
    cases["tiled_random"] = random_case(Vt, Ht)
    for name, case in hand_made_label_cases(Vt, Ht, dev).items():
        cases[f"tiled_{name}"] = case

    report = []
    for name, (lab0, right, down) in cases.items():
        ref = cuda_label.propagate_labels_torch(lab0, right, down,
                                                max_sweeps=100000)
        # bool and int32 edge images: both bit-equal to the plain version
        for edges in ("bool", "int32"):
            r, d = ((right, down) if edges == "bool" else
                    (right.to(torch.int32), down.to(torch.int32)))
            got = cuda_label.propagate_labels_cuda(lab0, r, d)
            torch.cuda.synchronize()
            n_bad = int(torch.sum(got != ref))
            if n_bad:
                raise AssertionError(
                    f"label kernel != plain on {name} ({edges} edges): "
                    f"{n_bad} pixels differ")
        seg = lab0 != cuda_label.SENTINEL
        report.append({"case": name, "shape": list(lab0.shape),
                       "segmentable": int(seg.sum()),
                       "components": int(torch.unique(ref[seg]).numel()),
                       "bit_equal": True})
    comps = {r["case"]: r["components"] for r in report}
    for prefix in ("", "tiled_"):
        assert tuple(comps[prefix + c] for c in (
            "wrap", "serpentine", "empty", "all_one")) == (2, 1, 0, 1), comps
    capture_check("label_ccl", cuda_label.propagate_labels_cuda,
                  cases["scan0"], cases[f"scan{len(scans) - 1}"])
    capture_check("label_ccl (HDL-64 image)",
                  cuda_label.propagate_labels_cuda,
                  cases["hdl64_scan"], cases["hdl64_random"])
    capture_check("label_ccl (tiled kernel)",
                  cuda_label.propagate_labels_cuda,
                  cases["tiled_random"], cases["tiled_serpentine"])

    lab0, right, down = cases[f"scan{len(scans) // 2}"]
    t = timed(lambda: cuda_label.propagate_labels_cuda(lab0, right, down))
    plain_ms = time_ms(
        lambda: cuda_label.propagate_labels_torch(lab0, right, down, 64))
    big_t = timed(lambda: cuda_label.propagate_labels_cuda(
        *cases["hdl64_scan"]))
    big_plain_ms = time_ms(lambda: cuda_label.propagate_labels_torch(
        *cases["hdl64_scan"], 64))
    tiled_t = timed(lambda: cuda_label.propagate_labels_cuda(
        *cases["tiled_random"]))
    tiled_plain_ms = time_ms(lambda: cuda_label.propagate_labels_torch(
        *cases["tiled_random"], 64), reps=5, warmup=1)
    batched = label_batched_checks(cases, scan_keys, gen, dev)

    def bound_ms(n_pixels):
        return least_s(k1_ops(n_pixels), k1_bytes(n_pixels), H100) * 1e3

    n_bytes = k1_bytes(V * H)
    bound = bound_ms(V * H)
    entry = {
        "name": "label_ccl", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/label.cu",
        "replaces": "lego_loam_tpu/frontend/pallas_label.py:145",
        "shape": [V, H], "max_abs_err": 0, **t, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "launch_floor_ms": floor,
        "bound_how": f"{n_bytes} bytes (int32 labels0 and two 1-byte masks "
                     f"read, int32 labels written) / "
                     f"{H100['hbm_bytes_per_s']:g} B/s; under one "
                     f"launch (launch_floor_ms)",
        "resources": kernel_resources("label_cluster_kernel",
                                      "label_grid_kernel"),
        "hdl64": {"shape": [Vb, Hb], **big_t, "plain_ms": big_plain_ms,
                  "bound_ms": bound_ms(Vb * Hb)},
        "tiled": {"shape": [Vt, Ht], **tiled_t, "plain_ms": tiled_plain_ms,
                  "bound_ms": bound_ms(Vt * Ht)},
        "batched": batched}
    batched["bound_ms"] = bound_ms(math.prod(batched["shape"]))
    batched["bound_by"] = "bytes"
    emit({"phase": "kernel", "kernel": "label_ccl", "cases": report,
          "graph_capture": True, **t, "plain_ms": plain_ms,
          "library_ms": None, "bound_ms": bound,
          "hdl64_scan": entry["hdl64"], "tiled_random": entry["tiled"],
          "batched": batched})
    return entry


def label_batched_checks(cases, scan_keys, gen, dev):
    """K1 on B images at once, (B, V, H): ONE launch, bit-equal to B single
    launches and to the plain version on the batch, with bool and int32
    edges, for groups that reach each kernel (clusters of 1 and 8 blocks,
    the tiled kernel) and for images of an odd pixel count, whose batch
    neighbours start off the 16-byte grid; replayed from a CUDA graph; then
    timed at the batched path's shape, (4, 16, 1800) from four scans,
    beside four single launches."""
    from lego_loam_tpu_torch.frontend import cuda_label

    def odd(rows, cols):
        rnd = lambda p: (torch.rand((rows, cols), generator=gen) < p).to(dev)
        return label_inputs(rnd(0.8), rnd(0.45), rnd(0.45))

    groups = {
        "vlp16_scans": [cases[k] for k in scan_keys],
        "vlp16_hand_made": [cases[k] for k in ("wrap", "serpentine",
                                               "empty", "all_one")],
        "hdl64": [cases["hdl64_scan"], cases["hdl64_random"]],
        "rows1": [cases["rows1_random"]] * 3,
        "odd_5x37": [odd(5, 37) for _ in range(3)],
        "odd_1x181": [odd(1, 181) for _ in range(3)],
        "tiled": [cases["tiled_random"], cases["tiled_serpentine"],
                  cases["tiled_wrap"]],
    }
    report = []
    for name, images in groups.items():
        stacked = [torch.stack([im[k] for im in images]).contiguous()
                   for k in range(3)]
        ref = cuda_label.propagate_labels_torch(*stacked, max_sweeps=100000)
        for edges in ("bool", "int32"):
            lab0, r, d = (stacked if edges == "bool" else
                          (stacked[0], stacked[1].to(torch.int32),
                           stacked[2].to(torch.int32)))
            before = cuda_label.launch_count
            got = cuda_label.propagate_labels_cuda(lab0, r, d)
            if cuda_label.launch_count != before + 1:
                raise AssertionError(f"batched label {name}: not one launch")
            singles = torch.stack([cuda_label.propagate_labels_cuda(
                lab0[k], r[k], d[k]) for k in range(len(images))])
            torch.cuda.synchronize()
            if not (torch.equal(got, singles) and torch.equal(got, ref)):
                raise AssertionError(
                    f"batched label kernel {name} ({edges} edges): "
                    f"{int(torch.sum(got != singles))} pixels differ from "
                    f"single launches, {int(torch.sum(got != ref))} from "
                    f"the plain version")
        report.append({"group": name, "shape": list(stacked[0].shape),
                       "one_launch": True, "bit_equal": True})
    vlp = [torch.stack([cases[k][i] for k in scan_keys]).contiguous()
           for i in range(3)]
    other = [torch.stack([cases[k][i] for k in
                          ("wrap", "serpentine", "empty", "all_one")])
             .contiguous() for i in range(3)]
    capture_check("label_ccl (batched)", cuda_label.propagate_labels_cuda,
                  vlp, other)
    t = timed(lambda: cuda_label.propagate_labels_cuda(*vlp))
    four = timed(lambda: [cuda_label.propagate_labels_cuda(
        vlp[0][k], vlp[1][k], vlp[2][k]) for k in range(len(scan_keys))])
    plain_ms = time_ms(lambda: cuda_label.propagate_labels_torch(*vlp, 64))
    emit({"phase": "kernel_batched", "kernel": "label_ccl", "groups": report,
          "graph_capture": True})
    return {"shape": list(vlp[0].shape), **t, "plain_ms": plain_ms,
            "library_ms": None, "max_abs_err": 0, "groups": report,
            "four_single_launches": four}


# --------------------------------------------------------------------------
# phase 3b: K2, 5 nearest neighbours
# --------------------------------------------------------------------------

def knn_case(Q, M, seed, dev, offset=200.0, invalid=0.1):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-30, 30, (Q, 3)) + offset).astype(np.float32)
    c = (rng.uniform(-30, 30, (M, 3)) + offset).astype(np.float32)
    qv = rng.random(Q) >= invalid
    cv = rng.random(M) >= invalid
    return tuple(torch.from_numpy(a).to(dev) for a in (q, qv, c, cv))


def exact_top6(q, c, cv, chunk=512):
    """Difference-first distances of every pair, six smallest per query."""
    vals, idxs = [], []
    for s in range(0, q.shape[0], chunk):
        diff = q[s:s + chunk, None, :] - c[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        d2 = torch.where(cv[None, :], d2, math.inf)
        v, i = torch.topk(d2, 6, dim=-1, largest=False, sorted=True)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def check_knn(name, q, qv, c, cv, result=None):
    """Kernel vs plain version (and vs an exact oracle); ``result`` is the
    kernel's ``(idx, d2)`` for these inputs where the caller already has it
    (from a grouped launch), else one single call is made.  Criteria: invalid
    queries all +inf; only valid candidates; ascending; distances rtol 1e-5;
    index lists equal to an exact difference-first oracle wherever its
    distances are not tied; against the plain version nearest equal and
    5-sets equal wherever the neighbouring distances differ by more than
    PLAIN_RANK_TOL."""
    from lego_loam_tpu_torch.match import cuda_knn
    idx_k, d2_k = (cuda_knn.knn5(q, qv, c, cv) if result is None
                   else result)
    torch.cuda.synchronize()
    idx_p, d2_p = cuda_knn.knn5_torch(q, qv, c, cv)
    assert idx_k.dtype == torch.int32 and d2_k.dtype == torch.float32
    assert idx_k.shape == idx_p.shape == (q.shape[0], 5)
    assert torch.all(d2_k[~qv] > FAR)
    assert torch.all(cv[idx_k.long()]), "kernel returned an invalid candidate"
    bad = idx_k[~qv].long()
    assert torch.all(bad[:, 1:] != bad[:, :-1]), "invalid query: repeated idx"
    rows = torch.nonzero(qv)[:, 0]
    ik, dk = idx_k[rows].long(), d2_k[rows]
    ip, dp = idx_p[rows].long(), d2_p[rows]
    assert torch.all(dk[:, 1:] >= dk[:, :-1]), "not ascending"
    o_d, o_i = exact_top6(q[rows], c, cv)
    # against the exact oracle the kernel is exact up to rounding of the sum
    torch.testing.assert_close(dk, o_d[:, :5], rtol=1e-5, atol=0.0)
    gap = o_d[:, 1:] - o_d[:, :-1]                       # (R, 5)
    tight = torch.all(gap > 1e-6 * o_d[:, 1:], dim=1)
    assert torch.all(ik[tight] == o_i[tight, :5]), "kernel != exact oracle"
    # against the plain version, whose distance MATRIX only ranks: its
    # float32 norm expansion is off by up to ~1e-3 m^2 for points 30 m from
    # the query centroid, so rows are compared where the neighbouring
    # distances differ by more than PLAIN_RANK_TOL
    def sets_differ(rows_mask):
        a = torch.sort(ik[rows_mask], dim=1).values
        b = torch.sort(ip[rows_mask], dim=1).values
        return int(torch.sum(torch.any(a != b, dim=1)))
    clear = gap[:, 4] > PLAIN_RANK_TOL
    assert float(clear.float().mean()) > 0.9
    assert sets_differ(clear) == 0, \
        f"{name}: 5-sets differ from the plain version"
    first = gap[:, 0] > PLAIN_RANK_TOL
    assert torch.all(ik[first, 0] == ip[first, 0]), "nearest differs"
    allclear = torch.all(gap > PLAIN_RANK_TOL, dim=1)
    torch.testing.assert_close(dk[allclear], dp[allclear], rtol=1e-5,
                               atol=0.0)
    flips = sets_differ(gap[:, 4] > 1e-4)
    err = float(torch.max(torch.abs(dk[allclear] - dp[allclear])))
    return {"case": name, "Q": q.shape[0], "M": c.shape[0],
            "valid_queries": int(rows.numel()),
            "valid_candidates": int(cv.sum()),
            "rows_compared": int(clear.sum()), "max_abs_err": err,
            "plain_rank_flips_above_1e-4": flips}


def knn_bound(*problems):
    """Least time of the searches on this card, in ms, and how it is
    bound: each input read once and the five (index, distance) pairs a query
    written once, against 8 flops per valid (query, candidate) pair."""
    n_bytes = sum(k2_bytes(q.shape[0], c.shape[0]) for q, _, c, _ in problems)
    n_ops = sum(k2_flops(int(qv.sum()) * int(cv.sum()))
                for _, qv, _, cv in problems)
    bound = least_s(n_ops, n_bytes, H100) * 1e3
    return bound, (f"{n_ops} flops (8 per valid pair) / "
                   f"{H100['fp32_flops_per_s']:g} vs {n_bytes} bytes / "
                   f"{H100['hbm_bytes_per_s']:g}")


def library_knn(q, qv, c, cv):
    d = torch.cdist(q, c)
    d = torch.where(cv[None, :], d, math.inf)
    return torch.topk(d, 5, dim=-1, largest=False)


def knn_grouped_checks(dev):
    """The grouped entry point, at the shapes one re-association of the
    mapping stage has: the launch the main path makes (corner and surf
    together) against the plain version and the exact oracle, a grouped
    launch against single calls, the in-kernel merge against itself over
    20 calls, and both entry points replayed from a CUDA graph."""
    from lego_loam_tpu_torch.match import cuda_knn
    corner = knn_case(1024, 16384, 201, dev)
    surf = knn_case(2048, 32768, 202, dev)
    ragged = knn_case(1000, 5000, 203, dev)
    pair = cuda_knn.knn5_grouped([corner, surf])
    against_plain = [
        check_knn("grouped_corner", *corner, result=pair[0]),
        check_knn("grouped_surf", *surf, result=pair[1])]
    single = [cuda_knn.knn5_cuda(*p) for p in (corner, surf, ragged)]
    before = cuda_knn.launch_count
    grouped = cuda_knn.knn5_grouped([corner, surf, ragged])
    assert cuda_knn.launch_count == before + 1, "grouped call: one launch"
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(flat(grouped), flat(single))):
        assert torch.equal(a, b), f"grouped != single calls (output {k})"
    for _ in range(20):
        again = cuda_knn.knn5_grouped([corner, surf])
        for k, (a, b) in enumerate(zip(flat(again), flat(single[:2]))):
            assert torch.equal(a, b), f"repeat call differs (output {k})"
    # a candidate view that starts off the 16-byte grid is staged
    q, qv, c, cv = ragged
    shifted = cuda_knn.knn5_cuda(q, qv, c[1:], cv[1:])
    ref = cuda_knn.knn5_cuda(q, qv, c[1:].clone(), cv[1:].clone())
    assert torch.equal(shifted[0], ref[0]) and torch.equal(shifted[1], ref[1])
    capture_check("knn5", cuda_knn.knn5_cuda, surf,
                  knn_case(2048, 32768, 204, dev))
    other = (knn_case(1024, 16384, 205, dev), knn_case(2048, 32768, 206, dev))
    capture_check(
        "knn5_grouped",
        lambda *t: cuda_knn.knn5_grouped([t[:4], t[4:]]),
        corner + surf, other[0] + other[1])
    pair_ms = timed(lambda: cuda_knn.knn5_grouped([corner, surf]))
    pair_ms["plain_ms"] = time_ms(
        lambda: [cuda_knn.knn5_torch(*p) for p in (corner, surf)])
    pair_ms["library_ms"] = time_ms(
        lambda: [library_knn(*p) for p in (corner, surf)])
    pair_ms["bound_ms"], pair_ms["bound_how"] = knn_bound(corner, surf)
    return {"case": "grouped_repeat_capture",
            "grouped_against_plain_and_oracle": against_plain,
            "max_abs_err": max(r["max_abs_err"] for r in against_plain),
            "grouped_equals_single": True,
            "repeats_identical": 20, "graph_capture": True,
            "corner_and_surf_in_one_launch": pair_ms}


def knn_phase(dev):
    from lego_loam_tpu_torch.match import cuda_knn
    # the pipeline's own shapes first (per-keyframe scan caps against the
    # map caps), then the larger ones
    shapes = [("map_corner", 1024, 16384), ("map_surf", 2048, 32768),
              ("corner_2048", 2048, 16384), ("surf_8192", 8192, 32768),
              ("icp_4096", 4096, 32768), ("ragged", 1000, 5000)]
    report, by_name = [], {}
    for k, (name, Q, M) in enumerate(shapes):
        case = knn_case(Q, M, 100 + k, dev)
        rep = check_knn(name, *case)
        q, qv, c, cv = case
        rep.update(timed(lambda: cuda_knn.knn5_cuda(*case)))
        rep["plain_ms"] = time_ms(lambda: cuda_knn.knn5_torch(*case))
        rep["library_ms"] = time_ms(lambda: library_knn(*case))
        rep["bound_ms"], rep["bound_how"] = knn_bound(case)
        report.append(rep)
        by_name[name] = rep
        del case, q, qv, c, cv
        torch.cuda.empty_cache()

    # fewer than five valid candidates, and none at all
    q, qv, c, cv = knn_case(64, 256, 7, dev, offset=0.0, invalid=0.0)
    cv[:] = False
    cv[[3, 17, 40]] = True
    idx, d2 = cuda_knn.knn5(q, qv, c, cv)
    pidx, pd2 = cuda_knn.knn5_torch(q, qv, c, cv)
    assert torch.all(d2[:, 3:] > FAR) and torch.all(idx[:, 3:] == 0)
    assert torch.all(d2[:, :3] < 1e4)
    assert torch.all(torch.sort(idx[:, :3]).values
                     == torch.tensor([3, 17, 40], device=dev))
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=0.0)
    cv[:] = False
    idx, d2 = cuda_knn.knn5(q, qv, c, cv)
    assert torch.all(d2 > FAR) and torch.all(idx == 0)
    report.append({"case": "fewer_than_5_valid", "ok": True})
    report.append(knn_grouped_checks(dev))

    head = by_name["map_surf"]
    entry = {
        "name": "knn5", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/knn5.cu",
        "replaces": "lego_loam_tpu/match/pallas_knn.py:134",
        "shape": [head["Q"], head["M"]],
        "max_abs_err": max(r.get("max_abs_err", 0.0) for r in report),
        **{k: head[k] for k in TIME_KEYS}, "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "operations",
        "library_ms": head["library_ms"], "bound_how": head["bound_how"],
        "resources": kernel_resources("knn5_kernel"),
        "corner_and_surf_in_one_launch": report[-1][
            "corner_and_surf_in_one_launch"],
        "other_shapes": {
            r["case"]: {k: r[k] for k in ("Q", "M", *TIME_KEYS, "plain_ms",
                                          "library_ms", "bound_ms")}
            for r in report if "ms" in r and r is not head}}
    emit({"phase": "kernel", "kernel": "knn5", "cases": report})
    return entry


# --------------------------------------------------------------------------
# phase 4: the pipeline on the card vs on the CPU, small size
# --------------------------------------------------------------------------

def small_config():
    from lego_loam_tpu_torch.core import config as C
    return C.LegoLoamConfig(
        laser=C.LaserConfig(num_horizontal_scans=360),
        feature=C.FeatureConfig(max_sharp=64, max_less_sharp=512,
                                max_flat=128, max_less_flat=2048),
        mapping=C.MappingConfig(enable_loop_closure=False,
                                max_map_corner=4096, max_map_surf=8192,
                                max_keyframes=128,
                                surrounding_keyframe_search_num=8),
        pipeline=C.PipelineConfig(max_points=8192, max_segmented=4096,
                                  max_outlier=1024))


def parity_phase(dev):
    """Same small sequence through ``replay`` on the card (kernels) and on
    the CPU (plain versions): counters equal, poses within 0.05 m /
    0.01 rad (sums run in another order; ties may break differently)."""
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.io.synthetic import make_sequence
    from lego_loam_tpu_torch.pipeline.slam import replay
    cfg = small_config()
    scans, _, times = make_sequence(12, cfg, seed=5, noise=0.01, speed=1.2)
    runs = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        x, v, t = pack_sequence(scans, times, cfg, device=where)
        state, outs = replay(x, v, t, cfg, device=where)
        runs[where.type] = (state, {k: o.cpu() for k, o in outs.items()})
    (gs, go), (cs, co) = runs["cuda"], runs["cpu"]
    assert gs.odo.odom.is_cuda and not cs.odo.odom.is_cuda
    assert int(gs.mapping.meta.kf_count) == int(cs.mapping.meta.kf_count) >= 1
    assert torch.equal(go["kf_count"], co["kf_count"])
    assert torch.equal(go["factor_count"], co["factor_count"])
    rot = float(torch.max(torch.abs(go["fused"][:, :3] - co["fused"][:, :3])))
    tr = float(torch.max(torch.abs(go["fused"][:, 3:] - co["fused"][:, 3:])))
    assert rot < 0.01 and tr < 0.05, (rot, tr)
    emit({"phase": "parity", "scans": 12, "config": "360-column test size",
          "max_rot_diff_rad": rot, "max_trans_diff_m": tr,
          "keyframes": int(gs.mapping.meta.kf_count)})


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------

def slice_phase(scans, gt, times, cfg, dev):
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core import se3
    from lego_loam_tpu_torch.eval.metrics import ate
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline.slam import replay

    n = len(scans)
    x, v, t = pack_sequence(scans, times, cfg, device=dev)
    replay(x[:10], v[:10], t[:10], cfg, device=dev)         # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    D.reset_sync_count()
    D.start_stage_timing()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    t0 = time.perf_counter()
    state, outs = replay(x, v, t, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    syncs = D.sync_count()
    stages = D.stage_times_ms()
    peak = torch.cuda.max_memory_allocated()

    fused = outs["fused"].cpu().numpy()
    assert fused.shape == (n, 6)
    for name in ("odom", "fused", "mapped"):
        assert bool(torch.isfinite(outs[name]).all()), f"{name} not finite"
    g = torch.from_numpy(np.asarray(gt, np.float32))
    gt_rel = se3.relative(g[0], g).numpy()
    err = ate(fused[:-1], gt_rel[1:n], align=False)

    meta = state.mapping.meta
    divider = cfg.mapping.mapping_frequency_divider
    cycles = n // divider
    kf_hist = outs["kf_count"].cpu().numpy()
    with_map = sum(1 for i in range(divider - 1, n, divider)
                   if i >= divider and kf_hist[i - divider] > 0)
    result = {
        "phase": "slice", "config": "vlp16, enable_loop_closure=False",
        "image": list(cfg.laser.image_size),
        "max_keyframes": cfg.mapping.max_keyframes,
        "scans": n, "wall_s": wall, "scans_per_s": n / wall,
        "ms_per_scan": 1e3 * wall / n,
        "ms_per_scan_projection_segmentation": stages["projection"] / n,
        "ms_per_scan_features_odometry": stages["odometry"] / n,
        "ms_per_scan_mapping": stages["mapping"] / n,
        "ms_per_mapping_cycle": stages["mapping"] / cycles,
        "ate": err, "keyframes": int(meta.kf_count),
        "factors": int(meta.factor_count),
        "kf_dropped": int(meta.kf_dropped),
        "factor_dropped": int(meta.factor_dropped),
        "map_sat": int(meta.map_sat), "mapping_cycles": cycles,
        "mapping_cycles_with_map": with_map, "launches": launches,
        "host_syncs": syncs, "host_syncs_per_scan": syncs / n,
        "max_memory_allocated_bytes": peak}
    emit(result)
    assert err["rmse"] < 0.5, err
    assert result["kf_dropped"] == result["factor_dropped"] == 0
    assert result["map_sat"] == 0
    assert result["keyframes"] > cycles // 2
    assert result["factors"] == result["keyframes"] - 1
    assert launches["label_ccl"] == n, launches
    assert with_map >= cycles - 2
    # one launch per re-association (corner and surf searched together),
    # at least one and at most scan2map_iters of them per mapping cycle
    assert (with_map <= launches["knn5"]
            <= cfg.mapping.scan2map_iters * with_map), launches
    return launches


LAP = dict(seed=21, noise=0.01, radius=6.5, speed=1.3)   # one 31.4 s lap
LAP_SCANS = 360
SMALL_LAP = dict(seed=33, noise=0.01, radius=2.2, speed=1.6)
SMALL_LAP_SCANS = 110


def small_loop_config():
    """The JAX package's loop-closure test geometry
    (``tests/test_loop_e2e.py::small_loop_cfg``) through the port's config."""
    from lego_loam_tpu_torch.core import config as C
    return C.LegoLoamConfig(
        laser=C.LaserConfig(num_horizontal_scans=450),
        feature=C.FeatureConfig(max_sharp=128, max_less_sharp=1024,
                                max_flat=256, max_less_flat=4096,
                                odom_surf_iters=15, odom_corner_iters=15),
        mapping=C.MappingConfig(
            max_map_corner=4096, max_map_surf=8192, max_keyframes=256,
            scan2map_iters=6, loop_closure_time_gap=4.0,
            loop_history_cap=16384, loop_source_cap=1024, icp_max_iters=30),
        pipeline=C.PipelineConfig(max_points=8192, max_segmented=8192,
                                  max_outlier=2048))


def pose_errors(fused, gt):
    """Per-scan position error as the bench takes it (estimate k against
    truth k+1, both relative to the first true pose) and the ATE."""
    from lego_loam_tpu_torch.core import se3
    from lego_loam_tpu_torch.eval.metrics import ate
    g = torch.from_numpy(np.asarray(gt, np.float32))
    gt_rel = se3.relative(g[0], g).numpy()
    n = len(fused)
    err = np.linalg.norm(fused[:-1, 3:] - gt_rel[1:n, 3:], axis=1)
    return err, ate(fused[:-1], gt_rel[1:n], align=False)


@contextlib.contextmanager
def launch_shapes():
    """Count K1 and K2 launches by shape while the block runs: a recording
    wrapper around each launch function (the wrappers' own launch counts
    are left as they are)."""
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.match import cuda_knn
    shapes = {"label_ccl": collections.Counter(),
              "knn5": collections.Counter()}
    label, knn = cuda_label.propagate_labels_cuda, cuda_knn.knn5_cuda_grouped

    def recording_label(labels0, right, down):
        shapes["label_ccl"]["x".join(map(str, labels0.shape))] += 1
        return label(labels0, right, down)

    def recording_knn(problems):
        shapes["knn5"][" + ".join(f"{p[0].shape[0]}x{p[2].shape[0]}"
                                  for p in problems)] += 1
        return knn(problems)

    cuda_label.propagate_labels_cuda = recording_label
    cuda_knn.knn5_cuda_grouped = recording_knn
    try:
        yield shapes
    finally:
        cuda_label.propagate_labels_cuda = label
        cuda_knn.knn5_cuda_grouped = knn


def loop_phase(lap, dev):
    """The default ``vlp16()`` — loop closure ON, nothing changed — on one
    lap of ``benchmarks/loop_closure_drive.py`` (360 scans, lap time 31.4 s
    past the 30 s loop gate), through ``replay``.  Every count is zeroed
    just before the run and read just after; the K2 launches are also
    counted by shape (``launch_shapes``, so the ICP ones at 4096 x 32768 can
    be told from scan-to-map's)."""
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.loop import icp
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline import mapping
    from lego_loam_tpu_torch.pipeline.slam import replay

    scans, gt, times = lap
    cfg = vlp16()
    assert cfg.mapping.enable_loop_closure
    n = len(scans)
    x, v, t = pack_sequence(scans, times, cfg, device=dev)
    replay(x[:10], v[:10], t[:10], cfg, device=dev)         # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    D.reset_sync_count()
    D.start_stage_timing()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    icp.iteration_count = 0
    mapping.resolve_count = 0
    mapping.pcg_iteration_count = 0
    with launch_shapes() as by_shape:
        t0 = time.perf_counter()
        state, outs = replay(x, v, t, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    shapes = by_shape["knn5"]
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    syncs = D.sync_count()
    stages = D.stage_times_ms()
    peak = torch.cuda.max_memory_allocated()
    icp_iters = icp.iteration_count
    resolves = mapping.resolve_count
    pcg_iters = mapping.pcg_iteration_count

    for name in ("odom", "fused", "mapped"):
        assert bool(torch.isfinite(outs[name]).all()), f"{name} not finite"
    fused = outs["fused"].cpu().numpy()
    err, ate_m = pose_errors(fused, gt)
    meta = state.mapping.meta
    kf, factors = int(meta.kf_count), int(meta.factor_count)
    diag = outs["loop_diag"].cpu().numpy()
    attempts = int((diag[:, 0] > 0).sum())
    with_candidate = int(((diag[:, 0] > 0) & (diag[:, 2] < 1e6)).sum())
    cycles = n // cfg.mapping.mapping_frequency_divider
    loop_ms = stages.get("loop_attempt", 0.0)
    resolve_ms = stages.get("loop_resolve", 0.0)
    rebuild_ms = stages.get("grid_rebuild", 0.0)
    icp_shape = f"{cfg.mapping.loop_source_cap}x{cfg.mapping.loop_history_cap}"
    result = {
        "phase": "loop", "config": "vlp16() unchanged (loop closure on)",
        "sequence": dict(scans=n, **LAP), "image": list(cfg.laser.image_size),
        "wall_s": wall, "scans_per_s": n / wall,
        "ms_per_scan": 1e3 * wall / n,
        "ms_per_scan_projection_segmentation": stages["projection"] / n,
        "ms_per_scan_features_odometry": stages["odometry"] / n,
        "ms_per_scan_mapping": stages["mapping"] / n,
        "mapping_cycles": cycles,
        "ms_per_mapping_cycle": stages["mapping"] / cycles,
        "ms_per_mapping_cycle_without_attempt":
            (stages["mapping"] - loop_ms - resolve_ms - rebuild_ms) / cycles,
        "ms_per_closure_attempt": loop_ms / max(attempts, 1),
        "ms_per_attempt_with_candidate":
            loop_ms / max(with_candidate, 1),
        "ms_per_resolve_optimize_poses": resolve_ms / max(resolves, 1),
        "ms_per_grid_rebuild": rebuild_ms / max(resolves, 1),
        "keyframes": kf, "factors": factors,
        "loop_factors": factors - (kf - 1),
        "closure_attempts": attempts,
        "attempts_with_candidate": with_candidate,
        "accepted": int((diag[:, 1] > 0).sum()),
        "relinearised": int((diag[:, 7] > 0).sum()),
        "implausible": int((diag[:, 7] < 0).sum()),
        "resolves": resolves, "pcg_iterations": pcg_iters,
        "pcg_iterations_per_resolve": pcg_iters / max(resolves, 1),
        "icp_iterations": icp_iters,
        "icp_iterations_per_attempt": icp_iters / max(with_candidate, 1),
        "ate": ate_m, "err_at_150_m": float(err[150]),
        "err_at_end_m": float(err[-1]),
        "kf_dropped": int(meta.kf_dropped),
        "factor_dropped": int(meta.factor_dropped),
        "map_sat": int(meta.map_sat), "launches": launches,
        "knn5_launches_by_shape": dict(sorted(shapes.items())),
        "knn5_launches_icp_shape": shapes[icp_shape],
        "host_syncs": syncs, "host_syncs_per_scan": syncs / n,
        "max_memory_allocated_bytes": peak}
    emit(result)
    assert result["loop_factors"] >= 1, "no loop closed on the lap"
    assert (result["kf_dropped"] == result["factor_dropped"]
            == result["map_sat"] == 0)
    assert ate_m["rmse"] < 2.0, ate_m
    assert result["err_at_end_m"] < result["err_at_150_m"], err[[150, -1]]
    assert launches["label_ccl"] == n, launches
    # ICP: one K2 launch per iteration plus the final fit, at the loop shape
    assert shapes[icp_shape] == icp_iters + with_candidate >= 2, (
        shapes, icp_iters, with_candidate)
    assert sum(shapes.values()) == launches["knn5"]
    return launches, state, outs, result


STAGE1_SCANS = 100
STAGE1_PROFILED = 20     # the last scans, traced once more on each side


def stage1_graphs_phase(lap, dev):
    """Stage 1 as the main path runs it, its two chains replayed from CUDA
    graphs (``core/graphs.py``) around the eager K1 launch, against the same
    chains called eagerly (``graphs.run`` patched to a plain call): the loop
    lap's first ``STAGE1_SCANS`` scans with ``vlp16()``.  Each scan's
    ``ProjectionOut`` must be bit-equal (asserted), and K1 called once a
    scan through ``segmentation.propagate_labels`` on each side (asserted);
    captures and replays a scan are the runner's counts, each side's ms a
    scan is timed with a synchronisation before and after, and its device
    time a scan is the sum of the device events of a ``torch.profiler``
    trace of the last ``STAGE1_PROFILED`` scans, run again."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lego_loam_tpu_torch.core import graphs
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.core.types import RawScan
    from lego_loam_tpu_torch.frontend import segmentation
    from lego_loam_tpu_torch.io.npz_io import pack_sequence

    scans, _, times = lap
    cfg = vlp16()
    n = min(STAGE1_SCANS, len(scans))
    x, v, t = pack_sequence(scans[:n], times[:n], cfg, device=dev)
    raws = [RawScan(xyz=x[i].reshape(-1, 3), valid=v[i], stamp=t[i])
            for i in range(n)]
    sides = {"graphs": contextlib.nullcontext,
             "eager": lambda: mock.patch.object(
                 graphs, "run", lambda fn, *args: fn(*args))}
    seconds = {side: [] for side in sides}
    k1_calls = dict.fromkeys(sides, 0)
    label = segmentation.propagate_labels
    side_now = [None]

    def counting(*args, **kwargs):
        k1_calls[side_now[0]] += 1
        return label(*args, **kwargs)

    c0 = graphs.capture_count()
    captures_by_scan, replays_by_scan, differing = [], [], []
    with mock.patch.object(segmentation, "propagate_labels", counting):
        for i, raw in enumerate(raws):
            got = {}
            for side, context in sides.items():
                side_now[0] = side
                with context():
                    torch.cuda.synchronize()
                    c, r = graphs.capture_count(), graphs.replay_count()
                    t0 = time.perf_counter()
                    got[side] = segmentation.image_projection(raw, cfg)
                    torch.cuda.synchronize()
                    seconds[side].append(time.perf_counter() - t0)
                    if side == "graphs":
                        captures_by_scan.append(graphs.capture_count() - c)
                        replays_by_scan.append(graphs.replay_count() - r)
            a, b = (tensors_of(got[side]) for side in sides)
            differing += [f"scan {i} leaf {k}"
                          for k, (p, q) in enumerate(zip(a, b))
                          if not torch.equal(p, q)]
    profiled = {}
    for side, context in sides.items():
        torch.cuda.synchronize()
        with context(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
            for raw in raws[-STAGE1_PROFILED:]:
                segmentation.image_projection(raw, cfg)
            torch.cuda.synchronize()
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        profiled[side] = {
            "device_ms_per_scan": sum(e.time_range.elapsed_us()
                                      for e in on_device)
            * 1e-3 / STAGE1_PROFILED,
            "device_events_per_scan": len(on_device) / STAGE1_PROFILED}
    warm = 2          # scans left out of the times: captures, first calls
    report = {"phase": "stage1_graphs", "scans": n,
              "config": "vlp16() unchanged, image_projection alone",
              "differing": differing[:20], "n_differing": len(differing),
              "captures": graphs.capture_count() - c0,
              "captures_after_scan_1": sum(captures_by_scan[warm:]),
              "replays_per_scan": sum(replays_by_scan) / n,
              "k1_calls": k1_calls,
              "ms_per_scan": {side: 1e3 * statistics.mean(s[warm:])
                              for side, s in seconds.items()},
              "ms_per_scan_median": {
                  side: 1e3 * statistics.median(s[warm:])
                  for side, s in seconds.items()},
              "profiled_scans": STAGE1_PROFILED, "profiled": profiled}
    emit(report)
    if differing:
        raise AssertionError(f"stage 1 replayed from graphs differs from the "
                             f"eager chain: {differing[:5]}")
    assert k1_calls["graphs"] == k1_calls["eager"] == n, k1_calls


STAGE2_SCANS = 100


def tensors_of(tree) -> list:
    """The tensors of a port container (nested dataclasses), in field
    order; nothing for ``None``."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name))]
    return []


def stage2_graphs_phase(lap, dev):
    """Stage 2 as the main path runs it, its chains replayed from CUDA
    graphs (``core/graphs.py``), against the same chains called eagerly
    (``graphs.run`` patched to a plain call): the loop lap's first
    ``STAGE2_SCANS`` scans from a fresh state with ``vlp16()``, stage 1 once
    a scan for both.  After every scan θ (``two_step_odometry`` on the
    step's inputs), the new state and the ``AssociationOut`` must be
    bit-equal (asserted); captures and replays a scan are the runner's
    counts, and each side's ms a scan is timed with a synchronisation; the
    replays and times are the steps' own (θ's solve is left out), the
    captures the phase's."""
    from unittest import mock

    from lego_loam_tpu_torch.core import graphs
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.core.types import RawScan
    from lego_loam_tpu_torch.frontend.features import extract_features
    from lego_loam_tpu_torch.frontend.segmentation import image_projection
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.pipeline import odometry
    from lego_loam_tpu_torch.solve.odometry import two_step_odometry

    scans, _, times = lap
    cfg = vlp16()
    n = min(STAGE2_SCANS, len(scans))
    x, v, t = pack_sequence(scans[:n], times[:n], cfg, device=dev)
    sides = {"graphs": contextlib.nullcontext,
             "eager": lambda: mock.patch.object(
                 graphs, "run", lambda fn, *args: fn(*args))}
    states = {side: odometry.init_state(cfg, dev) for side in sides}
    seconds = dict.fromkeys(sides, 0.0)
    c0 = graphs.capture_count()
    captures_by_scan, replays_by_scan, differing = [], [], []
    for i in range(n):
        proj = image_projection(
            RawScan(xyz=x[i].reshape(-1, 3), valid=v[i], stamp=t[i]), cfg)
        got = {}
        for side, context in sides.items():
            state = states[side]
            with context():
                theta = None
                if i:
                    feats = graphs.owned(graphs.run(
                        extract_features, proj.segmented, cfg))
                    theta = two_step_odometry(
                        state.transform_cur, feats.sharp, feats.flat,
                        state.last_corner, state.last_surf, cfg)
                torch.cuda.synchronize()
                c, r = graphs.capture_count(), graphs.replay_count()
                t0 = time.perf_counter()
                states[side], out = odometry.odometry_step(state, proj, cfg)
                torch.cuda.synchronize()
                seconds[side] += time.perf_counter() - t0
                if side == "graphs":
                    captures_by_scan.append(graphs.capture_count() - c)
                    replays_by_scan.append(graphs.replay_count() - r)
            got[side] = {"theta": theta, "state": states[side], "out": out}
        for part in ("theta", "state", "out"):
            a, b = (tensors_of(got[side][part]) for side in sides)
            differing += [f"scan {i} {part} leaf {k}"
                          for k, (p, q) in enumerate(zip(a, b))
                          if not torch.equal(p, q)]
    report = {"phase": "stage2_graphs", "scans": n,
              "config": "vlp16() unchanged, odometry_step alone",
              "differing": differing[:20], "n_differing": len(differing),
              "captures": graphs.capture_count() - c0,
              "captures_after_scan_10": sum(captures_by_scan[10:]),
              "replays_per_scan": sum(replays_by_scan) / n,
              "ms_per_scan": {side: 1e3 * s / n
                              for side, s in seconds.items()}}
    emit(report)
    if differing:
        raise AssertionError(f"stage 2 replayed from graphs differs from the "
                             f"eager chain: {differing[:5]}")


STAGE3_SCANS = 100


def stage3_graphs_phase(lap, dev):
    """Stage 3 as the main path runs it, its chains replayed from CUDA
    graphs (``core/graphs.py``), against the same chains called eagerly
    (``graphs.run`` patched to a plain call): the loop lap's first
    ``STAGE3_SCANS`` scans with ``vlp16()`` (loop closure on: a loop attempt
    every third cycle, no candidate this early), stages 1-2 once a scan and
    each side's mapping cycle on the same ``AssociationOut`` from a state of
    its own.  After every cycle its results and both sides' keyframe blocks
    must be bit-equal (asserted); each side's ms a cycle is timed with a
    synchronisation before and after, K2's problems are counted through its
    module attribute on each side, and captures and replays a cycle are the
    runner's counts."""
    from unittest import mock

    from lego_loam_tpu_torch.core import graphs
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.core.types import RawScan
    from lego_loam_tpu_torch.frontend.segmentation import image_projection
    from lego_loam_tpu_torch.graph import keyframes
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline import mapping, odometry
    from lego_loam_tpu_torch.pipeline.slam import mapping_due

    scans, _, times = lap
    cfg = vlp16()
    assert cfg.mapping.enable_loop_closure
    n = min(STAGE3_SCANS, len(scans))
    x, v, t = pack_sequence(scans[:n], times[:n], cfg, device=dev)
    sides = {"graphs": contextlib.nullcontext,
             "eager": lambda: mock.patch.object(
                 graphs, "run", lambda fn, *args: fn(*args))}
    states = {side: mapping.init_state(cfg, dev) for side in sides}
    seconds = {side: [] for side in sides}
    problems = dict.fromkeys(sides, 0)
    grouped = cuda_knn.knn5_cuda_grouped
    side_now = [None]

    def counting(batch):
        problems[side_now[0]] += len(batch)
        return grouped(batch)

    odo = odometry.init_state(cfg, dev)
    captures_by_cycle, replays_by_cycle, differing = [], [], []
    with mock.patch.object(cuda_knn, "knn5_cuda_grouped", counting):
        for i in range(n):
            proj = image_projection(
                RawScan(xyz=x[i].reshape(-1, 3), valid=v[i], stamp=t[i]), cfg)
            odo, assoc = odometry.odometry_step(odo, proj, cfg)
            if not mapping_due(i, cfg):
                continue
            got = {}
            for side, context in sides.items():
                st = states[side]
                side_now[0] = side
                with context():
                    torch.cuda.synchronize()
                    c, r = graphs.capture_count(), graphs.replay_count()
                    t0 = time.perf_counter()
                    meta, row, pose, diag = mapping.mapping_step(
                        st.meta, st.clouds, assoc, cfg)
                    torch.cuda.synchronize()
                    seconds[side].append(time.perf_counter() - t0)
                    if side == "graphs":
                        captures_by_cycle.append(graphs.capture_count() - c)
                        replays_by_cycle.append(graphs.replay_count() - r)
                clouds = keyframes.apply_row(st.clouds, row)
                states[side] = mapping.MappingState(
                    meta=meta.replace(bef_mapped=pose), clouds=clouds)
                got[side] = (meta, row, pose, diag, clouds)
            a, b = ([leaf for part in got[side] for leaf in tensors_of(part)]
                    for side in sides)
            k = len(replays_by_cycle) - 1
            differing += [f"cycle {k} leaf {j}"
                          for j, (p, q) in enumerate(zip(a, b))
                          if not torch.equal(p, q)]
            odo = odo.replace(odom=got["graphs"][2])
    cycles = len(replays_by_cycle)
    warm = 4          # cycles left out of the times: captures, first calls
    report = {"phase": "stage3_graphs", "scans": n, "cycles": cycles,
              "config": "vlp16() unchanged, mapping_step on stage 2's "
                        "output",
              "differing": differing[:20], "n_differing": len(differing),
              "captures": sum(captures_by_cycle),
              "captures_by_cycle": captures_by_cycle,
              "replays_per_cycle": sum(replays_by_cycle) / cycles,
              "knn5_problems": problems,
              "ms_per_cycle": {side: 1e3 * statistics.mean(s[warm:])
                               for side, s in seconds.items()},
              "ms_per_cycle_median": {
                  side: 1e3 * statistics.median(s[warm:])
                  for side, s in seconds.items()},
              "ms_first_cycles": {side: [1e3 * x for x in s[:warm]]
                                  for side, s in seconds.items()}}
    emit(report)
    if differing:
        raise AssertionError(f"stage 3 replayed from graphs differs from the "
                             f"eager chain: {differing[:5]}")
    assert problems["graphs"] == problems["eager"] > 0, problems


def resolve_phase(state, dev):
    """One pose-graph re-solve and grid rebuild, as an accepted closure past
    the relinearisation threshold runs them (``_close_loop``), on the final
    graph of the ``loop`` run (K = 8192 nodes, 10240 factor slots, its loop
    factors in): time between CUDA events (the host reads inside stall the
    stream, so this is what a caller waits), PCG iterations and host reads;
    the solve must not raise the weighted squared residual.  The lap's own
    closures can stay under the threshold, so the replay may run none."""
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.graph import submap_grid
    from lego_loam_tpu_torch.graph.posegraph import (_factor_blocks,
                                                     optimize_poses)
    cfg = vlp16()
    meta, clouds = state.mapping.meta, state.mapping.clouds
    window = cfg.mapping.surrounding_keyframe_search_num

    def solve(m):
        return optimize_poses(m.kf_pose, m.kf_count, m.graph, gn_iters=3,
                              pcg_iters=64, return_iters=True)

    solve(meta)                                          # warm-up
    times, reads = [], []
    for _ in range(3):
        D.reset_sync_count()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        poses, iters = solve(meta)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        reads.append(D.sync_count())
    rebuild_ms = time_ms(lambda: submap_grid.rebuild(
        poses, meta.kf_count, clouds, cfg, window))

    def cost(p):
        g = meta.graph
        r, _, _ = _factor_blocks(p, g, g.i.long(), g.j.long())
        prior = (p[0] - g.prior) * g.prior_weight
        return float(torch.sum(r * r) + torch.sum(prior * prior))

    n = int(meta.kf_count)
    before, after = cost(meta.kf_pose), cost(poses)
    emit({"phase": "resolve", "nodes": meta.kf_pose.shape[0], "alive": n,
          "factor_slots": meta.graph.i.shape[0],
          "factors": int(meta.factor_count),
          "optimize_poses_ms": statistics.median(times),
          "optimize_poses_ms_all": times, "pcg_iterations": iters,
          "host_reads": reads[-1], "grid_rebuild_ms": rebuild_ms,
          "cost_before": before, "cost_after": after,
          "max_pose_change": float(torch.max(torch.abs(
              poses[:n] - meta.kf_pose[:n])))})
    assert bool(torch.isfinite(poses).all())
    assert after <= before * (1 + 1e-6), (before, after)


def tree_differences(x, y, path: str = "") -> list:
    """The leaves (dotted paths) in which two nested dicts of NumPy arrays
    differ, bit for bit (NaN equal to NaN)."""
    if isinstance(y, dict):
        return [d for k in y for d in tree_differences(x[k], y[k],
                                                       f"{path}.{k}")]
    return [] if np.array_equal(x, y, equal_nan=True) else [path]


def state_differences(a, b) -> list:
    """The fields (dotted paths) in which two port states differ, bit for
    bit (NaN equal to NaN); row-sharded keyframe blocks are compared
    whole."""
    from lego_loam_tpu_torch import convert
    return tree_differences(convert.to_numpy_tree(a),
                            convert.to_numpy_tree(b))


def loop_parity_phase(small_lap, dev):
    """The JAX package's loop-closure test lap (110 scans, 450 columns)
    through ``replay`` twice on the card (kernels) and once on the CPU
    (plain versions).  ``determinism``: the two card runs must be bit-equal
    — every output and every field of the final state (the float sums are
    order-fixed, ``core/segsum.py``).  Card against CPU: keyframe and
    loop-factor counts equal, fused poses within 0.1 m (the 5-NN kernel and
    the plain version may break a tie differently; a closure found on one
    side only would move a pose far more)."""
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.pipeline.slam import replay
    scans, gt, times = small_lap
    cfg = small_loop_config()
    runs, card_runs = {}, []
    for name, where in (("card", dev), ("card_again", dev),
                        ("cpu", torch.device("cpu"))):
        x, v, t = pack_sequence(scans, times, cfg, device=where)
        t0 = time.perf_counter()
        state, outs = replay(x, v, t, cfg, device=where)
        if where.type == "cuda":
            torch.cuda.synchronize()
            card_runs.append((state, outs))
        meta = state.mapping.meta
        kf, factors = int(meta.kf_count), int(meta.factor_count)
        runs[name] = {
            "keyframes": kf, "loop_factors": factors - (kf - 1),
            "fused": outs["fused"].cpu().numpy(),
            "accepted": int((outs["loop_diag"][:, 1] > 0).sum()),
            "seconds": time.perf_counter() - t0}
    (s1, o1), (s2, o2) = card_runs
    outputs_differing = [k for k in o1 if not torch.equal(o1[k], o2[k])]
    state_differing = state_differences(s1, s2)
    del card_runs, s1, s2, o1, o2
    g, c = runs["card"], runs["cpu"]
    dev_m = float(np.max(np.linalg.norm(
        g["fused"][:, 3:] - c["fused"][:, 3:], axis=1)))
    err_g, ate_g = pose_errors(g["fused"], gt)
    _, ate_c = pose_errors(c["fused"], gt)
    emit({"phase": "loop_parity", "scans": len(scans), **SMALL_LAP,
          "config": "tests/test_loop_e2e.py::small_loop_cfg geometry",
          **{k: {f: x for f, x in r.items() if f != "fused"}
             for k, r in runs.items()},
          "max_fused_position_diff_m": dev_m,
          "ate_rmse_card": ate_g["rmse"], "ate_rmse_cpu": ate_c["rmse"],
          "determinism": {
              "outputs_differing": outputs_differing,
              "state_fields_differing": state_differing,
              "max_fused_diff_two_card_runs": float(np.max(np.abs(
                  g["fused"] - runs["card_again"]["fused"])))}})
    assert not outputs_differing and not state_differing, (
        outputs_differing, state_differing)
    assert g["keyframes"] == c["keyframes"], (g["keyframes"], c["keyframes"])
    assert g["loop_factors"] == c["loop_factors"] >= 1, (
        g["loop_factors"], c["loop_factors"])
    assert dev_m < 0.1, dev_m


def cli_phase(bench, dev):
    """``python -m lego_loam_tpu_torch.run --input seq.npz --output DIR``
    (its ``main``, in this process, on the card) on the slice's sequence:
    loop closure on (the CLI's default ``vlp16()``), every artifact the
    JAX package's CLI writes, the ATE in ``metrics.json``.  Then the same
    scans written to a ROS1 ``.bag`` (the port's ``io/rosbag.py::write_bag``,
    uncompressed, its one form) and replayed through ``--input x.bag``:
    keyframe and factor counts, keyframe poses and the fused trajectory
    equal to the ``.npz`` run's, bit for bit."""
    from lego_loam_tpu_torch import run
    from lego_loam_tpu_torch.io.npz_io import save_sequence
    from lego_loam_tpu_torch.io.rosbag import write_bag
    scans, gt, times = bench
    files = ("trajectory_odom.tum", "trajectory_fused.tum",
             "trajectory_mapped.tum", "trajectory_gt.tum", "map2d.pgm",
             "map2d_origin.npy", "keyframe_poses.npy", "global_map.npy",
             "metrics.json", "scan_debug_0.npz")
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq.npz")
        save_sequence(seq, scans, gt, times)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        rc = run.main(["--input", seq, "--output", out, "--debug-scan", "0"])
        seconds = time.perf_counter() - t0
        missing = [f for f in files
                   if not os.path.isfile(os.path.join(out, f))]
        with open(os.path.join(out, "metrics.json")) as f:
            metrics = json.load(f)
        kf_poses = np.load(os.path.join(out, "keyframe_poses.npy"))
        n_map = len(np.load(os.path.join(out, "global_map.npy")))

        bag = os.path.join(tmp, "seq.bag")
        t0 = time.perf_counter()
        write_bag(bag, scans, [float(t) for t in times])
        write_s = time.perf_counter() - t0
        bag_out = os.path.join(tmp, "bag_out")
        t0 = time.perf_counter()
        bag_rc = run.main(["--input", bag, "--output", bag_out])
        bag_seconds = time.perf_counter() - t0
        with open(os.path.join(bag_out, "metrics.json")) as f:
            bag_metrics = json.load(f)
        bag_poses_equal = np.array_equal(
            np.load(os.path.join(bag_out, "keyframe_poses.npy")), kf_poses)
        fused_equal = {}
        for name in ("trajectory_fused.tum", "trajectory_odom.tum"):
            with open(os.path.join(out, name)) as a, \
                    open(os.path.join(bag_out, name)) as b:
                fused_equal[name] = a.read() == b.read()
        bag_bytes = os.path.getsize(bag)
    bag_entry = {
        "rc": bag_rc, "bag_bytes": bag_bytes, "write_bag_s": write_s,
        "read_bag_s": bag_metrics["stages"]["read_bag"]["total_s"],
        "replay_s": bag_metrics["stages"]["replay"]["total_s"],
        "seconds": bag_seconds, "scans_per_sec": bag_metrics["scans_per_sec"],
        "keyframes": bag_metrics.get("keyframes"),
        "factors": bag_metrics.get("factors"),
        "keyframe_poses_equal_npz": bag_poses_equal,
        "trajectories_equal_npz": fused_equal}
    emit({"phase": "cli", "rc": rc, "seconds": seconds, "missing": missing,
          "scans_per_sec": metrics.get("scans_per_sec"),
          "ate": metrics.get("ate"), "keyframes": metrics.get("keyframes"),
          "factors": metrics.get("factors"),
          "global_map_points": n_map, "bag": bag_entry})
    assert rc == 0 and not missing, missing
    assert metrics["ate"]["rmse"] < 0.5, metrics["ate"]
    assert kf_poses.shape == (metrics["keyframes"], 6)
    assert np.isfinite(kf_poses).all() and n_map > 1000
    assert bag_rc == 0, bag_rc
    assert (bag_entry["keyframes"], bag_entry["factors"]) == (
        metrics["keyframes"], metrics["factors"]), bag_entry
    assert bag_poses_equal and all(fused_equal.values()), bag_entry


# --------------------------------------------------------------------------
# phase 8: HDL-64 (KITTI geometry) end to end, and the banded search
# --------------------------------------------------------------------------

DRIVE = dict(seed=13, noise=0.01, speed=2.0, radius=10.0)   # 314-scan lap
DRIVE_SCANS = 330            # the drive of benchmarks/kitti64_drive.py
DRIVE_CHUNK = 15             # scans a worker makes per job
DRIVE_CHECKED = 2            # first scans held against make_sequence's
BANDED_SCANS = 120
# the pick caps the ring-blocked layout needs: exactly V·picks·sectors
BANDED_CAPS = dict(max_sharp=768, max_less_sharp=7680, max_flat=1536)


def drive_trajectory():
    from lego_loam_tpu_torch.core.config import hdl64
    from lego_loam_tpu_torch.io.synthetic import circle_trajectory
    return circle_trajectory(DRIVE_SCANS, radius=DRIVE["radius"],
                             speed=DRIVE["speed"],
                             period=hdl64().laser.scan_period)


def drive_chunk(start: int, stop: int):
    """Scans ``start .. stop-1`` of ``make_sequence(DRIVE_SCANS, hdl64(),
    **DRIVE)``, made by the same calls ``io/synthetic.py::make_sequence``
    makes (the world cleared along the whole lap, scan i seeded ``seed +
    i``), so that worker processes can share one sequence."""
    from lego_loam_tpu_torch.core.config import hdl64
    from lego_loam_tpu_torch.io import synthetic
    cfg = hdl64()
    _, times, pose_fn = drive_trajectory()
    period = cfg.laser.scan_period
    lap = np.arange(0, 2.0 * np.pi * DRIVE["radius"] / DRIVE["speed"],
                    period)
    world = synthetic.default_world(DRIVE["seed"],
                                    path_xy=pose_fn(lap)[:, 3:5])
    return [synthetic.simulate_scan(pose_fn, times[i], cfg, world,
                                    noise=DRIVE["noise"],
                                    seed=DRIVE["seed"] + i)
            for i in range(start, stop)]


def drive_sequence(chunks, check):
    """(scans, gt, times) of the drive from its chunks; the first scans
    must equal ``make_sequence``'s (``check``) bit for bit."""
    scans = [scan for chunk in chunks for scan in chunk]
    gt, times, _ = drive_trajectory()
    gt, times = gt.astype(np.float32), times.astype(np.float32)
    ref_scans, ref_gt, ref_times = check
    assert len(scans) == DRIVE_SCANS
    for k, (a, b) in enumerate(zip(ref_scans, scans)):
        assert np.array_equal(a, b, equal_nan=True), f"drive scan {k}"
    assert np.array_equal(ref_gt, gt[:len(ref_gt)])
    assert np.array_equal(ref_times, times[:len(ref_times)])
    return scans, gt, times


def timed_replay(seq, cfg, dev, with_fused: bool = False,
                 packed=None, mesh=None) -> dict:
    """``replay`` of a whole sequence on the card after a warm-up on its
    first 10 scans; every count zeroed just before the run and read just
    after; wall time ends in ``torch.cuda.synchronize()``.  ``with_fused``:
    the fused poses too, under ``fused``; ``packed``: the scans already
    packed on the card (``seq``'s scans are then not read); ``mesh``: the
    replay's (the keyframe blocks row-sharded over it)."""
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.loop import icp
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline import mapping
    from lego_loam_tpu_torch.pipeline.slam import replay

    scans, gt, times = seq
    x, v, t = packed or pack_sequence(scans, times, cfg, device=dev)
    n = x.shape[0]
    replay(x[:10], v[:10], t[:10], cfg, device=dev, mesh=mesh)   # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    D.reset_sync_count()
    D.start_stage_timing()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    icp.iteration_count = 0
    mapping.resolve_count = 0
    mapping.pcg_iteration_count = 0
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        state, outs = replay(x, v, t, cfg, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    icp_iters = icp.iteration_count
    resolves = mapping.resolve_count
    pcg_iters = mapping.pcg_iteration_count
    syncs = D.sync_count()
    stages = D.stage_times_ms()
    peak = torch.cuda.max_memory_allocated()
    del x, v, t

    for name in ("odom", "fused", "mapped"):
        assert bool(torch.isfinite(outs[name]).all()), f"{name} not finite"
    err, ate_m = pose_errors(outs["fused"].cpu().numpy(), gt)
    meta = state.mapping.meta
    kf, factors = int(meta.kf_count), int(meta.factor_count)
    cycles = n // cfg.mapping.mapping_frequency_divider
    diag = outs["loop_diag"].cpu().numpy()
    extra = {"fused": outs["fused"].cpu().numpy()} if with_fused else {}
    return {
        **extra,
        "scans": n, "wall_s": wall, "scans_per_s": n / wall,
        "ms_per_scan": 1e3 * wall / n,
        "ms_per_scan_by_stage": {k: ms / n for k, ms in stages.items()},
        "ms_per_mapping_cycle": stages.get("mapping", 0.0) / cycles,
        "host_syncs_per_scan": syncs / n,
        "max_memory_allocated_bytes": peak,
        "keyframes": kf, "factors": factors,
        "loop_factors": factors - (kf - 1), "ate": ate_m,
        "err_at_scan_m": {k: float(err[k])
                          for k in sorted({10, len(err) // 2, len(err) - 1})},
        "closure_attempts": int((diag[:, 0] > 0).sum()),
        "attempts_with_candidate": int(((diag[:, 0] > 0)
                                        & (diag[:, 2] < 1e6)).sum()),
        "accepted": int((diag[:, 1] > 0).sum()), "icp_iterations": icp_iters,
        "resolves": resolves, "pcg_iterations": pcg_iters,
        "ms_per_resolve": stages.get("loop_resolve", 0.0) / max(resolves, 1),
        "kf_dropped": int(meta.kf_dropped),
        "factor_dropped": int(meta.factor_dropped),
        "map_sat": int(meta.map_sat), "launches": launches,
        "launches_by_shape": {k: dict(c) for k, c in shapes.items()}}


def hdl64_phase(drive, dev):
    """``hdl64()`` as shipped — KITTI geometry, 64 x 2083 image,
    ``max_points`` 140032, loop closure on, banded search off — on the
    330-scan drive (the JAX package's ``KITTI64_r05.json`` reached ATE rmse
    0.338 m, 66 keyframes, 1 loop factor on it)."""
    from lego_loam_tpu_torch.core.config import hdl64
    cfg = hdl64()
    assert cfg.mapping.enable_loop_closure
    assert cfg.feature.odom_band_rings == 0
    r = timed_replay(drive, cfg, dev)
    emit({"phase": "hdl64",
          "config": "hdl64() unchanged (loop closure on, banded search off)",
          "sequence": dict(scans=len(drive[0]), **DRIVE),
          "image": list(cfg.laser.image_size),
          "max_points": cfg.pipeline.max_points, **r})
    assert r["loop_factors"] >= 1, "no loop closed on the drive"
    assert r["ate"]["rmse"] < 0.6, r["ate"]
    assert r["kf_dropped"] == r["factor_dropped"] == r["map_sat"] == 0
    assert r["launches"]["label_ccl"] == r["scans"], r["launches"]
    assert r["launches"]["knn5"] > 0, r["launches"]
    return r["launches"]


def banded_phase(drive, dev):
    """The first ``BANDED_SCANS`` scans of the drive through ``replay`` with
    the banded odometry search (``odom_band_rings=4``) and, in the same call,
    without it, both with the pick caps the banded layout needs."""
    from lego_loam_tpu_torch.core.config import hdl64
    base = hdl64()
    prefix = tuple(a[:BANDED_SCANS] for a in drive)
    runs = {}
    for rings in (4, 0):
        feature = dataclasses.replace(base.feature, odom_band_rings=rings,
                                      **BANDED_CAPS)
        runs[rings] = timed_replay(prefix, base.replace(feature=feature), dev)

    emit({"phase": "banded", "sequence": dict(scans=BANDED_SCANS, **DRIVE),
          "caps": BANDED_CAPS,
          **{f"odom_band_rings_{rings}": dict(
              r, ms_per_scan_odometry=r["ms_per_scan_by_stage"].get(
                  "odometry")) for rings, r in runs.items()},
          "ate_rmse_banded_minus_full_m":
              runs[4]["ate"]["rmse"] - runs[0]["ate"]["rmse"]})
    for rings, r in runs.items():
        assert r["ate"]["rmse"] < 0.6, (rings, r["ate"])
    assert runs[4]["launches"]["label_ccl"] == BANDED_SCANS, runs[4]
    assert runs[4]["launches"]["knn5"] > 0, runs[4]["launches"]
    return runs[4]["launches"]


# --------------------------------------------------------------------------
# phase 9: multi-stream and multi-device
# --------------------------------------------------------------------------

BATCH_SEEDS = (42, 43, 44, 45)     # stream 0 is the slice's sequence
BATCH_SCANS = 100
SHARDED_SCANS = 60


def batched_phase(streams, dev):
    """``pipeline.slam.batched_replay`` of 4 streams lock-step, ``vlp16()``
    as shipped (loop closure on), beside ``replay`` of stream 0 alone in
    the same call.  Every count zeroed just before each run and read just
    after; K1 must launch once per scan-step for all 4 streams."""
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline.slam import batched_replay
    cfg = vlp16()
    B, n = len(streams), len(streams[0][0])
    packed = [pack_sequence(sc, tm, cfg, device=dev) for sc, _, tm in streams]
    x, v, t = (torch.stack([p[k] for p in packed]) for k in range(3))
    batched_replay(x[:, :10], v[:, :10], t[:, :10], cfg, device=dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    D.reset_sync_count()
    D.start_stage_timing()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        states, outs = batched_replay(x, v, t, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    syncs = D.sync_count()
    stages = D.stage_times_ms()
    peak = torch.cuda.max_memory_allocated()
    del x, v, t, packed

    per_stream = []
    for b, ((_, gt, _), st) in enumerate(zip(streams, states)):
        for name in ("odom", "fused", "mapped"):
            assert bool(torch.isfinite(outs[name][b]).all()), (b, name)
        _, ate_m = pose_errors(outs["fused"][b].cpu().numpy(), gt)
        meta = st.mapping.meta
        per_stream.append({
            "seed": BATCH_SEEDS[b], "ate": ate_m,
            "keyframes": int(meta.kf_count),
            "factors": int(meta.factor_count),
            "kf_dropped": int(meta.kf_dropped),
            "factor_dropped": int(meta.factor_dropped),
            "map_sat": int(meta.map_sat)})
    single = timed_replay(streams[0], cfg, dev, with_fused=True)
    fused0 = outs["fused"][0].cpu().numpy()
    result = {
        "phase": "batched", "config": "vlp16() unchanged (loop closure on)",
        "streams": B, "scans_per_stream": n,
        "sequences": [dict(seed=s, noise=0.01, speed=1.2)
                      for s in BATCH_SEEDS[:B]],
        "wall_s": wall, "aggregate_scans_per_s": B * n / wall,
        "single_stream_scans_per_s": single["scans_per_s"],
        "aggregate_over_single": (B * n / wall) / single["scans_per_s"],
        "ms_per_scan_step": 1e3 * wall / n,
        "ms_per_scan_step_by_stage": {k: ms / n for k, ms in stages.items()},
        "host_syncs_per_scan_step": syncs / n,
        "max_memory_allocated_bytes": peak, "per_stream": per_stream,
        "launches": launches,
        "launches_by_shape": {k: dict(c) for k, c in shapes.items()},
        "single_stream_0": {k: single[k] for k in (
            "scans_per_s", "ms_per_scan", "ms_per_scan_by_stage",
            "host_syncs_per_scan", "keyframes", "factors", "ate",
            "launches")}}
    dev_m = float(np.max(np.linalg.norm(
        fused0[:, 3:] - single["fused"][:, 3:], axis=1)))
    result["stream0_max_fused_position_diff_m"] = dev_m
    emit(result)
    image = "x".join(map(str, (B, *cfg.laser.image_size)))
    assert launches["label_ccl"] == n, launches          # one launch a step
    assert shapes["label_ccl"] == {image: n}, shapes["label_ccl"]
    assert launches["knn5"] > 0, launches
    for r in per_stream:
        assert r["ate"]["rmse"] < 0.5, r
        assert r["kf_dropped"] == r["factor_dropped"] == r["map_sat"] == 0
    assert (per_stream[0]["keyframes"], per_stream[0]["factors"]) == (
        single["keyframes"], single["factors"]), (per_stream[0], single)
    assert dev_m < 0.1, dev_m
    return launches, outs


def knn_two_streams_check(dev, calls: int = 50):
    """K2 from two host threads, each on a CUDA stream of its own, at the
    scan-to-map shapes (1024 x 16384 + 2048 x 32768 in one launch), on
    different inputs: every one of the 2 x ``calls`` results equals the
    single call's on the same inputs (a plan shared between the threads, or
    scratch shared between the streams, would mix them)."""
    from lego_loam_tpu_torch.match import cuda_knn
    inputs = [[knn_case(1024, 16384, 300 + k, dev),
               knn_case(2048, 32768, 310 + k, dev)] for k in range(2)]
    refs = [cuda_knn.knn5_grouped(p) for p in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    results = [[], []]
    errors = []

    def work(k):
        try:
            streams[k].wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(streams[k]):
                for _ in range(calls):
                    results[k].append(cuda_knn.knn5_grouped(inputs[k]))
        except BaseException as e:      # noqa: BLE001 — raised below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("two-stream 5-NN check: a thread hung")
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    for k in range(2):
        assert len(results[k]) == calls
        for got in results[k]:
            for a, b in zip(flat(got), flat(refs[k])):
                if not torch.equal(a, b):
                    raise AssertionError(f"two-stream 5-NN: thread {k} "
                                         f"result differs from one call")
    shapes = ((1024, 16384), (2048, 32768))
    plan_streams = {key[1] for key in cuda_knn._plans if key[2] == shapes}
    assert len(plan_streams) >= 3, plan_streams   # default + the two
    return {"threads": 2, "calls_each": calls, "all_equal": True,
            "plans_for_shape": len(plan_streams)}


def sharded_phase(streams, batched_outs, loop_meta, small_lap, loop_lap,
                  loop_run, dev):
    """``distributed.mesh.replay_sharded`` over a mesh of 2 shards on the
    one card (two host threads, K2 and K1 from both) on the first
    ``SHARDED_SCANS`` scans of the batched streams, against
    ``batched_replay``'s; the two-stream K2 check; the factor-sharded solve
    on the loop run's final graph on meshes of 1 and 2 shards against
    ``optimize_poses``; ``replay(mesh=…)`` on the small lap over
    ``SMALL_LAP_SHARDS`` shards (its 22 keyframe rows cross from shard 0
    into shard 1) with a re-solve at every accepted closure, each re-solve
    held to ``optimize_poses`` on its own input graph (the solve
    tolerance), the counts to the run without a mesh, the blocks
    reassembled to that run's bit for bit, and the fused poses' difference
    reported beside that of two runs without a mesh; then
    :func:`mesh_lap_run` on ``loop_lap``, the ``loop`` phase's lap, over
    ``MESH_SHARDS`` shards.  Returns the launches of ``replay_sharded`` and
    of the full lap, apart."""
    from lego_loam_tpu_torch import convert
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.distributed import sharded_pgo
    from lego_loam_tpu_torch.distributed.mesh import make_mesh, replay_sharded
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.graph.posegraph import optimize_poses
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline import mapping
    from lego_loam_tpu_torch.pipeline.slam import replay
    card = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else dev)     # (a CPU rehearsal: the CPU)
    cfg = vlp16()
    n = SHARDED_SCANS
    packed = [pack_sequence(sc[:n], tm[:n], cfg, device=dev)
              for sc, _, tm in streams]
    x, v, t = (torch.stack([p[k] for p in packed]) for k in range(3))
    mesh = make_mesh(2, devices=[card, card])
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    t0 = time.perf_counter()
    states, outs = replay_sharded(x, v, t, cfg, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    del x, v, t, packed
    B = len(streams)
    diff = float(torch.max(torch.linalg.norm(
        outs["fused"][:, :, 3:] - batched_outs["fused"][:, :n, 3:], dim=-1)))
    counts_equal = all(
        torch.equal(outs[k][:, n - 1], batched_outs[k][:, n - 1])
        for k in ("kf_count", "factor_count"))
    sharded = {"shards": 2, "streams": B, "scans": n, "wall_s": wall,
               "aggregate_scans_per_s": B * n / wall, "launches": launches,
               "counts_equal_batched": counts_equal,
               "max_fused_position_diff_m": diff}
    two_streams = knn_two_streams_check(dev)

    meta = loop_meta
    solves = {}
    ref, _ = optimize_poses(meta.kf_pose, meta.kf_count, meta.graph,
                            gn_iters=3, pcg_iters=64, return_iters=True)
    # 0 shards: ``optimize_poses`` itself, timed the same way in turn
    for shards in (0, 1, 2, 0, 1, 2):
        pmesh = make_mesh(max(shards, 1), devices=[card] * max(shards, 1))

        def solve():
            if shards == 0:
                return optimize_poses(meta.kf_pose, meta.kf_count,
                                      meta.graph, gn_iters=3, pcg_iters=64,
                                      return_iters=True)
            return sharded_pgo.optimize_poses_sharded(
                meta.kf_pose, meta.kf_count, meta.graph, pmesh, gn_iters=3,
                pcg_iters=64, return_iters=True)
        solve()                                           # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            poses, iters = solve()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        entry = solves.setdefault(f"shards_{shards}", {
            "ms_all": [], "pcg_iterations": iters,
            "max_pose_diff": float(torch.max(torch.abs(poses - ref)))})
        entry["ms_all"] += times
        entry["ms"] = statistics.median(entry["ms_all"])

    scans, _, times_ = small_lap
    lap_cfg = small_loop_config()
    lap_cfg = lap_cfg.replace(mapping=dataclasses.replace(
        lap_cfg.mapping, loop_relin_trans=-1.0))
    lx, lv, lt = pack_sequence(scans, times_, lap_cfg, device=dev)
    r0 = mapping.resolve_count
    plain_state, plain = replay(lx, lv, lt, lap_cfg, device=dev)
    resolves = mapping.resolve_count - r0
    _, plain_again = replay(lx, lv, lt, lap_cfg, device=dev)
    # every in-pipeline re-solve is recorded with its input graph, to be
    # held to ``optimize_poses`` on that same input: the two runs' fused
    # poses differ also by the card's float atomics, whose run-to-run
    # spread the second plain run reads
    records = []
    solve_sharded = mapping.optimize_poses_sharded

    def recorded(poses, node_count, g, **kw):
        out = solve_sharded(poses, node_count, g, **kw)
        records.append((poses.clone(), node_count.clone(),
                        g.replace(**{f.name: getattr(g, f.name).clone()
                                     for f in dataclasses.fields(g)}),
                        out[0].clone()))
        return out
    s0 = sharded_pgo.solve_count
    lap_mesh = make_mesh(SMALL_LAP_SHARDS,
                         devices=[card] * SMALL_LAP_SHARDS)
    mapping.optimize_poses_sharded = recorded
    try:
        mesh_state, meshed = replay(lx, lv, lt, lap_cfg, device=dev,
                                    mesh=lap_mesh)
    finally:
        mapping.optimize_poses_sharded = solve_sharded
    sharded_solves = sharded_pgo.solve_count - s0
    blocks_differing = tree_differences(
        convert.to_numpy_tree(mesh_state.mapping.clouds),
        convert.to_numpy_tree(plain_state.mapping.clouds))
    rows_written = [int(p.any(dim=1).sum())
                    for p in mesh_state.mapping.clouds.surf_valid.parts]
    resolve_diffs = [
        float(torch.max(torch.abs(out - optimize_poses(
            poses, n_kf, g, gn_iters=3, pcg_iters=64))))
        for poses, n_kf, g, out in records]

    def fused_diff(a, b):
        return float(torch.max(torch.linalg.norm(
            a["fused"][:, 3:] - b["fused"][:, 3:], dim=-1)))
    lap = {
        "scans": len(scans), "resolves_without_mesh": resolves,
        "sharded_solves_with_mesh": sharded_solves,
        "resolves_recorded": len(records),
        "max_pose_diff_each_resolve": resolve_diffs,
        "keyframes": [int(plain_state.mapping.meta.kf_count),
                      int(mesh_state.mapping.meta.kf_count)],
        "factors": [int(plain_state.mapping.meta.factor_count),
                    int(mesh_state.mapping.meta.factor_count)],
        "max_fused_position_diff_m": fused_diff(plain, meshed),
        "max_fused_position_diff_plain_runs_m": fused_diff(plain,
                                                           plain_again),
        "shards": SMALL_LAP_SHARDS, "rows_written_by_shard": rows_written,
        "blocks_differing": blocks_differing}
    del plain_state, mesh_state
    full_lap, mesh_launches = mesh_lap_run(loop_lap, loop_run, dev, card)
    emit({"phase": "sharded", "replay_sharded": sharded,
          "knn5_two_threads_two_streams": two_streams,
          "optimize_poses_sharded": solves, "replay_with_mesh": lap,
          "replay_with_mesh_full_lap": full_lap})
    assert counts_equal, "replay_sharded counts != batched_replay's"
    assert diff < 0.1, diff
    assert launches["label_ccl"] == 2 * n, launches       # one a shard a step
    assert launches["knn5"] > 0, launches
    for shards in (1, 2):
        r = solves[f"shards_{shards}"]
        assert r["max_pose_diff"] < 5e-3, r
        assert max(r["pcg_iterations"]) < 64, r
    assert resolves >= 1 and sharded_solves == resolves, lap
    assert len(records) == sharded_solves, lap
    assert max(resolve_diffs) < 5e-3, lap
    assert lap["keyframes"][0] == lap["keyframes"][1], lap
    assert lap["factors"][0] == lap["factors"][1], lap
    assert not blocks_differing, blocks_differing
    assert sum(w > 0 for w in rows_written) >= 2, rows_written
    r = full_lap
    assert not r["outputs_differing"], r["outputs_differing"]
    assert not r["state_fields_differing"], r["state_fields_differing"]
    assert not r["shard_rows_differing"], r["shard_rows_differing"]
    assert r["shard_rows"] == [r["rows_per_shard"]] * MESH_SHARDS, r
    assert r["host_syncs_per_scan"] == r["loop_host_syncs_per_scan"], r
    assert r["launches"] == r["loop_launches"], r
    assert r["launches"]["label_ccl"] == r["scans"], r
    return launches, mesh_launches


MESH_SHARDS = 4
SMALL_LAP_SHARDS = 16        # 256 rows: 16 a shard, the lap's 22 span two


def mesh_devices(card, n: int = MESH_SHARDS):
    """``n`` shard devices and what they are: every card in turn when the
    machine has two or more, else ``card`` n times."""
    cards = torch.cuda.device_count() if card.type == "cuda" else 1
    if cards >= 2:
        return ([torch.device("cuda", k % cards) for k in range(n)],
                f"{n} shards over {cards} cards")
    return [card] * n, f"{n} shards on one device ({card})"


def mesh_lap_run(lap, loop_run, dev, card):
    """``replay(mesh=…)`` of the ``loop`` phase's lap (``vlp16()`` as
    shipped, 360 scans, K = 8192) with the keyframe blocks row-sharded over
    ``MESH_SHARDS`` shards (:func:`mesh_devices`).  Its lap's closures never
    re-solve, so it must equal the ``loop`` run of this call bit for bit:
    every output, every field of the final state (the blocks reassembled),
    the host reads and the kernel launches; each shard must hold exactly its
    rows of the loop run's blocks.  Scans/s beside ``loop``'s (reported).
    Every count is zeroed just before the run and read just after; returns
    (the reading, the launches)."""
    from lego_loam_tpu_torch import convert
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.distributed.mesh import make_mesh
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline.slam import replay

    scans, _, times = lap
    cfg = vlp16()
    n = len(scans)
    devices, placement = mesh_devices(card)
    mesh = make_mesh(MESH_SHARDS, devices=devices)
    x, v, t = pack_sequence(scans, times, cfg, device=dev)
    replay(x[:10], v[:10], t[:10], cfg, device=dev, mesh=mesh)   # warm-up
    torch.cuda.synchronize()

    D.reset_sync_count()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    t0 = time.perf_counter()
    state, outs = replay(x, v, t, cfg, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    syncs = D.sync_count()
    del x, v, t

    clouds = state.mapping.clouds
    ref = loop_run["tree"]["mapping"]["clouds"]
    r = clouds.surf.per_shard
    shard_bytes = [0] * MESH_SHARDS
    rows_differing = []
    for name in ref:
        for k, part in enumerate(getattr(clouds, name).parts):
            shard_bytes[k] += part.numel() * part.element_size()
            if not np.array_equal(part.cpu().numpy(),
                                  ref[name][k * r:(k + 1) * r]):
                rows_differing.append(f"{name}[{k}]")
    result = {
        "placement": placement, "devices": [str(d) for d in devices],
        "scans": n, "wall_s": wall, "scans_per_s": n / wall,
        "loop_scans_per_s": loop_run["scans_per_s"],
        "rows_per_shard": r, "shard_rows": [p.shape[0] for p in
                                            clouds.surf.parts],
        "rows_written_by_shard": [int(p.any(dim=1).sum())
                                  for p in clouds.surf_valid.parts],
        "block_bytes_by_shard": shard_bytes,
        "memory_allocated_by_card": {
            str(d): torch.cuda.memory_allocated(d)
            for d in sorted(set(devices), key=str)},
        "host_syncs": syncs, "host_syncs_per_scan": syncs / n,
        "loop_host_syncs_per_scan": loop_run["host_syncs"] / n,
        "launches": launches, "loop_launches": loop_run["launches"],
        "keyframes": int(state.mapping.meta.kf_count),
        "outputs_differing": [k for k in loop_run["outs"] if not torch.equal(
            outs[k].cpu(), loop_run["outs"][k])],
        "state_fields_differing": tree_differences(
            convert.to_numpy_tree(state), loop_run["tree"]),
        "shard_rows_differing": rows_differing}
    return result, launches


MULTIHOST_SCANS = 5
MULTIHOST_WAIT_S = 300


def multihost_run(procs: int, backend: str, dev, out: str,
                  local_devices: int = 2, bench: bool = False,
                  n_scans: int = MULTIHOST_SCANS) -> dict:
    """``python -m lego_loam_tpu_torch.distributed.multihost`` in ``procs``
    processes on this card (``local_devices`` shards each; ``bench``: the
    timed replay): their results, or an error with their stderr.  Every
    process is killed on a timeout."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo",
               NCCL_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "lego_loam_tpu_torch.distributed.multihost",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes",
           str(procs), "--out", out, "--backend", backend, "--device",
           f"cuda:{dev.index or 0}", "--local-devices", str(local_devices),
           "--n-scans", str(n_scans)] + (["--bench"] if bench else [])
    workers = [subprocess.Popen(cmd + ["--process-id", str(k)], cwd=root,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
               for k in range(procs)]
    logs = []
    try:
        for w in workers:
            logs.append(w.communicate(timeout=MULTIHOST_WAIT_S))
    except subprocess.TimeoutExpired:
        for w in workers:
            w.kill()
        logs = [w.communicate() for w in workers]
        raise AssertionError(f"multihost {backend} x {procs} timed out:\n"
                             + "\n".join(e.decode()[-3000:] for _, e in logs))
    for k, (w, (_, err)) in enumerate(zip(workers, logs)):
        if w.returncode != 0:
            raise AssertionError(f"multihost {backend} worker {k} rc "
                                 f"{w.returncode}:\n{err.decode()[-4000:]}")
    return dict(np.load(out))


def multihost_phase(dev):
    """The ``torch.distributed`` runtime on the one card: 2 processes over
    ``gloo`` (two ranks may share a card only there), each with 2 shards on
    ``cuda:0`` — the psum, the factor-sharded solve across processes, the
    ``replay`` over the global mesh with a keyframe row on every shard (its
    gathers all-reduced), the gathered data-parallel replay — and 1 process
    over ``nccl`` with 2 shards (NCCL takes one rank per card).  Held to the
    single-device solve (1e-4, as on the CPU), the meshed replay to a
    one-process replay without a mesh on the card bit for bit (fused poses
    and reassembled blocks), and each stream to its own ``replay`` on the
    card (0.01 m / rad)."""
    from lego_loam_tpu_torch.distributed import multihost
    from lego_loam_tpu_torch.graph.posegraph import optimize_poses
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.pipeline.slam import replay
    poses, n_nodes, g = multihost._pgo_graph(dev)
    ref = optimize_poses(poses, n_nodes, g, gn_iters=6, pcg_iters=64)
    ref = ref.cpu().numpy()
    cfg = multihost.replay_config()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for procs, backend in ((2, "gloo"), (1, "nccl")):
            t0 = time.perf_counter()
            z = multihost_run(procs, backend, dev,
                              os.path.join(tmp, f"{backend}.npz"))
            n = 2 * procs
            solve_ok = bool(np.all(np.abs(z["solved"] - ref)
                                   <= 1e-4 + 1e-4 * np.abs(ref)))
            solve_diff = float(np.max(np.abs(z["solved"] - ref)))
            fused = z["fused"]
            replay_diff = 0.0
            for stream in range(n):
                scans, _, times_ = multihost.stream_sequence(
                    stream, MULTIHOST_SCANS)
                x, v, t = pack_sequence(scans, times_, cfg, device=dev)
                own = replay(x, v, t, cfg, device=dev)[1]["fused"]
                replay_diff = max(replay_diff, float(np.max(np.abs(
                    fused[stream] - own.cpu().numpy()))))
            store_cfg = multihost.store_config(n)
            scans, _, times_ = multihost.stream_sequence(0, n)
            one_state, one = replay(*pack_sequence(scans, times_, store_cfg,
                                                   device=dev),
                                    store_cfg, device=dev)
            meshed = {
                "rows_written_by_shard": z["mesh_rows_per_shard"].tolist(),
                "all_reduces": int(z["mesh_all_reduces"]),
                "fused_equal_one_process": bool(np.array_equal(
                    z["mesh_fused"], one["fused"].cpu().numpy())),
                "blocks_differing": [
                    name for name, blk in vars(one_state.mapping.clouds)
                    .items() if not np.array_equal(z[f"mesh_{name}"],
                                                   blk.cpu().numpy())]}
            report[backend] = {
                "processes": procs, "shards": int(z["n_devices"]),
                "seconds": time.perf_counter() - t0,
                "psum": float(z["psum"]), "psum_expected": n * (n - 1) / 2,
                "pcg_iterations": z["pcg_iterations"].tolist(),
                "max_solve_diff": solve_diff, "solve_within_1e-4": solve_ok,
                "all_reduces": int(z["all_reduces"]),
                "gathered_fused_shape": list(fused.shape),
                "max_replay_diff": replay_diff, "replay_with_mesh": meshed}
    emit({"phase": "multihost", **report})
    for backend, r in report.items():
        assert r["shards"] == 2 * r["processes"], r
        assert r["psum"] == r["psum_expected"], r
        assert r["solve_within_1e-4"], r
        # every partial sum went through the backend's all_reduce (with one
        # process too): the psum check's, then per GN step the gradient, D,
        # the chain sub-diagonal and one H·x a PCG iteration
        it = r["pcg_iterations"]
        assert r["all_reduces"] == 1 + 3 * len(it) + sum(it), r
        assert r["gathered_fused_shape"] == [r["shards"], MULTIHOST_SCANS, 6]
        assert r["max_replay_diff"] < 0.01, r
        m = r["replay_with_mesh"]
        assert m["rows_written_by_shard"] == [1] * r["shards"], r
        assert m["all_reduces"] > 0, r
        assert m["fused_equal_one_process"] and not m["blocks_differing"], r


# --------------------------------------------------------------------------
# phase 10: the input paths and the BASELINE.json configurations
# --------------------------------------------------------------------------

FEED_CHECK_SCANS = 50


def feed_check(scans, cfg, dev) -> dict:
    """``io/native_feeder.py::DeviceFeed`` on the card: ``FEED_CHECK_SCANS``
    scans through the channel into its two pinned buffers, each copy queued
    behind a ~1 ms device sleep so that the copies lag the host's next
    ``recv``; every scan's device copy must equal what ``pack_scan_native``
    makes of its source (one pinned buffer without the event wait would
    hand a later scan's points to an earlier copy)."""
    from lego_loam_tpu_torch.io import native_feeder as nf
    C = cfg.pipeline.max_points
    channel = nf.ScanChannel(C, depth=1)
    sources = scans[:FEED_CHECK_SCANS]

    def produce():
        try:
            for i, pts in enumerate(sources):
                channel.send(pts, 0.1 * i)
        finally:
            channel.close()

    producer = threading.Thread(target=produce)
    producer.start()
    feed = nf.DeviceFeed(channel, dev)
    got = []
    try:
        while True:
            torch.cuda._sleep(1_000_000)
            raw = feed.recv()
            if raw is None:
                break
            got.append(raw)
    finally:
        channel.close()
        producer.join(timeout=60)
    torch.cuda.synchronize()
    wrong = []
    for i, (raw, pts) in enumerate(zip(got, sources)):
        xyz, valid, _ = nf.pack_scan_native(pts, C)
        if not (np.array_equal(raw.xyz.cpu().numpy(), xyz)
                and np.array_equal(raw.valid.cpu().numpy(), valid)
                and float(raw.stamp) == float(np.float32(0.1 * i))):
            wrong.append(i)
    result = {"scans": len(got), "wrong": wrong,
              "pinned": bool(feed._bufs[0][0].is_pinned())}
    assert not producer.is_alive()
    assert len(got) == len(sources) and not wrong and result["pinned"], result
    return result


def streaming_phase(bench, dev):
    """The live mode: the slice's scans with ``vlp16()`` as shipped (loop
    closure on) through ``run.stream`` — what ``run.main --streaming``
    runs: a producer thread sends each scan through the native channel,
    the loop receives it into a pinned buffer, copies it to the card and
    runs one ``slam_step``, and reads the fused pose on the host.  Latency
    per scan from ``recv`` to that pose, against the sensor's 100 ms;
    the fused trajectory must equal ``replay``'s on the same scans bit for
    bit.  Counts zeroed just before the stream and read just after."""
    from lego_loam_tpu_torch import run
    from lego_loam_tpu_torch.core import device as D
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.frontend import cuda_label
    from lego_loam_tpu_torch.match import cuda_knn
    scans, gt, times = bench
    cfg = vlp16()
    n = len(scans)
    ref = timed_replay(bench, cfg, dev, with_fused=True)
    feed = feed_check(scans, cfg, dev)

    D.reset_sync_count()
    cuda_label.launch_count = 0
    cuda_knn.launch_count = 0
    t0 = time.perf_counter()
    state, outs, latency_ms, mapped = run.stream(scans, times, cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"label_ccl": cuda_label.launch_count,
                "knn5": cuda_knn.launch_count}
    syncs = D.sync_count()
    fused = outs["fused"].cpu().numpy()
    _, ate_m = pose_errors(fused, gt)
    attempted = (outs["loop_diag"][:, 0] > 0).cpu().numpy()
    meta = state.mapping.meta
    result = {
        "phase": "streaming", "config": "vlp16() unchanged (loop closure on)",
        "scans": n, "wall_s": wall, "scans_per_s": n / wall,
        "replay_scans_per_s": ref["scans_per_s"],
        "latency": run.latency_summary(latency_ms, mapped,
                                       1e3 * cfg.laser.scan_period),
        "latency_ms_closure_attempts": np.asarray(latency_ms)[
            attempted].tolist(),
        "host_syncs_per_scan": syncs / n,
        "keyframes": int(meta.kf_count), "factors": int(meta.factor_count),
        "ate": ate_m, "fused_equal_replay": bool(np.array_equal(
            fused, ref["fused"])),
        "max_fused_diff_replay": float(np.max(np.abs(fused - ref["fused"]))),
        "launches": launches, "feed_check": feed}
    emit(result)
    assert result["fused_equal_replay"], result["max_fused_diff_replay"]
    assert (result["keyframes"], result["factors"]) == (
        ref["keyframes"], ref["factors"])
    assert launches["label_ccl"] == n and launches["knn5"] > 0, launches
    return launches


def odometry_phase(bench, dev):
    """``BASELINE.json`` config 3, odometry only (``pipeline.odometry_only``,
    no mapping, so no K2) on the slice's scans: scans/s, ms a scan by stage,
    ATE (the JAX package's ``ODOM_r05.json`` read 2.63 m on 200 scans, an
    accuracy only)."""
    from lego_loam_tpu_torch.core.config import vlp16
    base = vlp16()
    cfg = base.replace(pipeline=dataclasses.replace(base.pipeline,
                                                    odometry_only=True))
    r = timed_replay(bench, cfg, dev)
    emit({"phase": "odometry", "config": "vlp16(), odometry_only=True",
          **{k: r[k] for k in ("scans", "wall_s", "scans_per_s",
                               "ms_per_scan", "ms_per_scan_by_stage",
                               "host_syncs_per_scan", "ate", "keyframes",
                               "launches", "max_memory_allocated_bytes")}})
    assert r["launches"]["knn5"] == 0, r["launches"]
    assert r["launches"]["label_ccl"] == r["scans"], r["launches"]
    assert np.isfinite(r["ate"]["rmse"]), r["ate"]
    assert r["keyframes"] == 0
    return {"label_ccl": r["launches"]["label_ccl"]}


SESSIONS = (314, 200)        # benchmarks/multi_session.py: one lap, then 200
SESSION_SEED = 3
SESSION_GAP_S = 40.0
SESSION_CHUNK = 30


def session_trajectory(n1: int, n2: int):
    """(gt (n1+n2, 6), times, pose_fn, t_off) of
    ``benchmarks/multi_session.py::make_two_sessions``: one circle, session
    2 retracing it after a ``SESSION_GAP_S`` gap in the stamps."""
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.io.synthetic import circle_trajectory
    period = vlp16().laser.scan_period
    gt1, t1, pose_fn = circle_trajectory(n1, radius=6.5, speed=1.3,
                                         period=period)
    t_off = n1 * period + SESSION_GAP_S
    t2 = np.arange(n2) * period + t_off
    gt2 = np.stack([pose_fn(t - t_off) for t in t2]).reshape(n2, 6)
    return np.concatenate([gt1, gt2]), np.concatenate([t1, t2]), pose_fn, \
        t_off


def session_chunk(start: int, stop: int, n1: int, n2: int):
    """Scans ``start .. stop-1`` of the two sessions, made by the calls
    ``make_two_sessions(n1, n2, vlp16(), seed=SESSION_SEED)`` makes (the
    world cleared along the whole lap; session 1's scan i seeded seed + i,
    session 2's scan j seed + n1 + j), so worker processes can share the
    sequence (``tests/test_torch_sessions.py`` holds it to the original)."""
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.io import synthetic
    cfg = vlp16()
    _, times, pose_fn, t_off = session_trajectory(n1, n2)
    full = pose_fn(np.arange(0, 2 * np.pi * 6.5 / 1.3 + 0.1,
                             cfg.laser.scan_period))
    world = synthetic.default_world(SESSION_SEED, path_xy=full[:, 3:5])

    def shifted(tt):
        return pose_fn(tt - t_off)
    return [synthetic.simulate_scan(pose_fn if i < n1 else shifted,
                                    times[i], cfg, world, noise=0.01,
                                    seed=SESSION_SEED + i)
            for i in range(start, stop)]


def multisession_phase(scans, dev):
    """``BASELINE.json`` config 5, ``benchmarks/multi_session.py``: two
    sessions over one world (314 + 200 scans, 40 s stamp gap, world seed
    3), ``vlp16()`` as shipped.  Replayed whole, and split: session 1
    through ``replay``, its state written and read by ``io/checkpoint.py``,
    session 2 through ``replay_from`` the restored state.  The split must
    equal the whole run bit for bit (the JAX package's
    ``MULTISESSION_r05.json`` read 0.0: 102 keyframes, 13 loop factors, ATE
    0.255 m)."""
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.io.checkpoint import load_state, save_state
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.pipeline.slam import (init_state, replay,
                                                   replay_from)
    cfg = vlp16()
    n1 = SESSIONS[0]
    gt, times, _, _ = session_trajectory(*SESSIONS)
    gt = gt.astype(np.float32)
    packed = pack_sequence(scans, times, cfg, device=dev)
    whole = timed_replay((scans, gt, times), cfg, dev, with_fused=True,
                         packed=packed)
    x, v, t = packed
    t0 = time.perf_counter()
    s1, outs1 = replay(x[:n1], v[:n1], t[:n1], cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session1.npz")
        t1 = time.perf_counter()
        save_state(path, s1)
        restored = load_state(path, init_state(cfg, dev))
        ckpt_s = time.perf_counter() - t1
        ckpt_bytes = os.path.getsize(path)
    del s1
    state, outs2 = replay_from(restored, x[n1:], v[n1:], t[n1:], cfg,
                               device=dev)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    del packed, x, v, t
    split = torch.cat([outs1["fused"], outs2["fused"]]).cpu().numpy()
    diff = float(np.max(np.abs(split - whole["fused"])))
    fused = whole["fused"]
    _, ate1 = pose_errors(fused[:n1 + 1], gt[:n1 + 1])
    err, _ = pose_errors(fused, gt)
    meta = state.mapping.meta
    result = {
        "phase": "multisession", "config": "vlp16() unchanged",
        "sessions": list(SESSIONS), "stamp_gap_s": SESSION_GAP_S,
        "world_seed": SESSION_SEED,
        **{k: whole[k] for k in (
            "scans", "wall_s", "scans_per_s", "ms_per_scan_by_stage",
            "keyframes", "factors", "loop_factors", "ate", "err_at_scan_m",
            "closure_attempts", "accepted", "resolves", "ms_per_resolve",
            "kf_dropped", "factor_dropped", "map_sat", "launches",
            "launches_by_shape", "max_memory_allocated_bytes")},
        "ate_session1": ate1,
        "ate_session2_rmse": float(np.sqrt(np.mean(err[n1:] ** 2))),
        "split_seconds": split_s, "checkpoint_seconds": ckpt_s,
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_split_max_pose_diff": diff,
        "split_counts": [int(meta.kf_count), int(meta.factor_count)]}
    emit(result)
    assert diff == 0.0, diff
    assert result["split_counts"] == [whole["keyframes"], whole["factors"]]
    assert whole["loop_factors"] >= 1, whole["loop_factors"]
    assert whole["kf_dropped"] == whole["factor_dropped"] \
        == whole["map_sat"] == 0
    assert whole["launches"]["label_ccl"] == whole["scans"]
    assert whole["launches"]["knn5"] > 0
    return whole["launches"]


# --------------------------------------------------------------------------
# phase 11 (--long): Stevens scale, process scaling, traces, D-1's cost,
# the HDL-64 drive on the CPU
# --------------------------------------------------------------------------

STEVENS_SCANS = 2000         # benchmarks/stevens_stress.py's default N
STEVENS_PERIOD = 700         # one figure-eight (70 s), generated and tiled
STEVENS_SEED = 77
STEVENS_KF_CAP = 4096        # the script's KF_CAP for N <= 4000
STEVENS_CHUNK = 25
STEVENS_MESH_ATE_TOL = 0.01  # m: the meshed run's ATE against the whole's


def stevens_chunk(start: int, stop: int):
    """Scans ``start .. stop-1`` of ``make_sequence(STEVENS_PERIOD,
    vlp16(), seed=STEVENS_SEED, noise=0.01, trajectory="figure8")``, made
    by the calls ``make_sequence`` makes (its first scans are held to it,
    as the drive's are)."""
    from lego_loam_tpu_torch.core.config import vlp16
    from lego_loam_tpu_torch.io import synthetic
    cfg = vlp16()
    period = cfg.laser.scan_period
    _, times, pose_fn = synthetic.figure_eight_trajectory(
        STEVENS_PERIOD, scan_period=period)
    # make_sequence clears the whole figure-eight (700 scans) of the world
    full, _, _ = synthetic.figure_eight_trajectory(700, scan_period=period)
    world = synthetic.default_world(STEVENS_SEED, path_xy=full[:, 3:5])
    return [synthetic.simulate_scan(pose_fn, times[i], cfg, world,
                                    noise=0.01, seed=STEVENS_SEED + i)
            for i in range(start, stop)]


def stevens_config():
    """``vlp16()`` with the caps ``benchmarks/stevens_stress.py`` sets for
    N <= 4000: 4096 keyframes, at least 1024 loop factors."""
    from lego_loam_tpu_torch.core.config import vlp16
    cfg = vlp16()
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=STEVENS_KF_CAP,
        max_loop_factors=max(1024, cfg.mapping.max_loop_factors)))


def stevens_phase(chunks, check, dev):
    """``BASELINE.json`` config 2 at the size of
    ``benchmarks/stevens_stress.py``'s default: the 700-scan figure-eight
    (seed 77) tiled to 2000 scans (the vehicle retraces the same poses in
    the same world, so lap k's scans are lap 1's; only the stamps
    advance), through ``replay`` with the script's caps; then again with a
    mesh of ``MESH_SHARDS`` shards (the 4096 keyframe rows row-sharded, each
    re-solve factor-sharded and followed by a rebuild that gathers from
    every shard), held to the whole-store run in its counts and, within
    ``STEVENS_MESH_ATE_TOL``, its ATE.  Returns the two runs' launches."""
    from lego_loam_tpu_torch.distributed.mesh import make_mesh
    from lego_loam_tpu_torch.io.npz_io import pack_sequence
    from lego_loam_tpu_torch.io.synthetic import figure_eight_trajectory
    cfg = stevens_config()
    base = [scan for chunk in chunks for scan in chunk]
    assert len(base) == STEVENS_PERIOD
    ref_scans, ref_gt, _ = check
    for k, (a, b) in enumerate(zip(ref_scans, base)):
        assert np.array_equal(a, b, equal_nan=True), f"stevens scan {k}"
    n = STEVENS_SCANS
    period = cfg.laser.scan_period
    gt1, _, _ = figure_eight_trajectory(STEVENS_PERIOD, scan_period=period)
    assert np.array_equal(ref_gt, gt1[:len(ref_gt)].astype(np.float32))
    gt = np.tile(gt1, (n // STEVENS_PERIOD + 1, 1))[:n].astype(np.float32)
    times = (np.arange(n) * period).astype(np.float32)
    xb, vb, _ = pack_sequence(base, times[:STEVENS_PERIOD], cfg, device=dev)
    rows = torch.arange(n, device=dev) % STEVENS_PERIOD
    packed = (xb[rows], vb[rows], torch.from_numpy(times).to(dev))
    del xb, vb
    r = timed_replay((None, gt, times), cfg, dev, with_fused=True,
                     packed=packed)
    card = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else dev)     # (a CPU rehearsal: the CPU)
    devices, placement = mesh_devices(card)
    m = timed_replay((None, gt, times), cfg, dev, with_fused=True,
                     packed=packed, mesh=make_mesh(MESH_SHARDS,
                                                   devices=devices))
    del packed
    counts = ("keyframes", "loop_factors", "resolves", "kf_dropped",
              "factor_dropped", "map_sat")
    meshed = {"placement": placement,
              **{k: m[k] for k in counts + ("scans_per_s", "ms_per_resolve",
                                            "host_syncs_per_scan",
                                            "launches", "ate")},
              "ate_rmse_diff_m": m["ate"]["rmse"] - r["ate"]["rmse"],
              "max_fused_position_diff_m": float(np.max(np.linalg.norm(
                  m.pop("fused")[:, 3:] - r.pop("fused")[:, 3:], axis=1)))}
    emit({"phase": "stevens",
          "config": "vlp16(), max_keyframes 4096, max_loop_factors >= 1024",
          "sequence": dict(scans=n, period=STEVENS_PERIOD, seed=STEVENS_SEED,
                           trajectory="figure8", noise=0.01), **r,
          "replay_with_mesh": meshed})
    assert r["kf_dropped"] == r["factor_dropped"] == r["map_sat"] == 0, r
    assert r["loop_factors"] >= 1, r["loop_factors"]
    assert np.isfinite(r["ate"]["rmse"]), r["ate"]
    assert r["launches"]["label_ccl"] == n, r["launches"]
    # the placement changes no result; only the sharded re-solves sum in
    # another order (1.1e-4 m on the small lap)
    assert all(m[k] == r[k] for k in counts), meshed
    assert abs(meshed["ate_rmse_diff_m"]) < STEVENS_MESH_ATE_TOL, meshed
    assert m["launches"]["label_ccl"] == n, m["launches"]
    return r["launches"], m["launches"]


SCALING_SCANS = 40


def scaling_phase(dev):
    """``benchmarks/scaling.py``'s question on the one card: the
    data-parallel replay (``multihost --bench``, the workers' small config,
    ``SCALING_SCANS`` scans a stream, a stream a shard) in 1 and in 2
    ``gloo`` processes with one shard each, beside 1 process with 2 shards
    (``replay_sharded``'s two host threads)."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for procs, local in ((1, 1), (2, 1), (1, 2), (1, 1)):
            t0 = time.perf_counter()
            z = multihost_run(procs, "gloo", dev,
                              os.path.join(tmp, f"b{procs}{local}.npz"),
                              local_devices=local, bench=True,
                              n_scans=SCALING_SCANS)
            runs.setdefault(f"processes_{procs}_shards_each_{local}", []) \
                .append({"aggregate_scans_per_s": float(z["rate"]),
                         "seconds_timed": float(z["seconds"]),
                         "seconds_with_start_up":
                             time.perf_counter() - t0})
    one = statistics.median(
        r["aggregate_scans_per_s"] for r in runs["processes_1_shards_each_1"])
    emit({"phase": "scaling", "scans_per_stream": SCALING_SCANS,
          "backend": "gloo", "runs": runs,
          "two_processes_over_one": runs["processes_2_shards_each_1"][0][
              "aggregate_scans_per_s"] / one,
          "two_threads_over_one": runs["processes_1_shards_each_2"][0][
              "aggregate_scans_per_s"] / one})


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=200,
                    help="scans of the main-path replay (at least 60)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--long", action="store_true",
                    help="add the long phases: stevens and scaling")
    args = ap.parse_args()
    if args.scans < 60:
        ap.error("--scans must be at least 60")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device present", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lego_loam_tpu_torch import convert, hostlib, kernels
    from lego_loam_tpu_torch.core.config import hdl64, vlp16
    from lego_loam_tpu_torch.io.synthetic import make_sequence

    t_start = time.time()
    dev = torch.device("cuda")
    device_phase()

    cfg = vlp16()
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, enable_loop_closure=False))
    # the sequences are made on the host while the kernels build and the
    # 5-NN kernel is checked and timed on the device; every phase that
    # times the host (eager launches, replays) waits until they are made
    workers = max(3, min(7, (os.cpu_count() or 4) - 1))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        jobs = {
            "lap": pool.submit(make_sequence, LAP_SCANS, vlp16(), **LAP),
            "bench": pool.submit(make_sequence, args.scans, cfg,
                                 seed=args.seed, noise=0.01, speed=1.2),
            "small_lap": pool.submit(make_sequence, SMALL_LAP_SCANS,
                                     small_loop_config(), **SMALL_LAP),
            "drive_check": pool.submit(make_sequence, DRIVE_CHECKED,
                                       hdl64(), **DRIVE)}
        # the batched streams: stream 0 is the slice's sequence (whose
        # scans are a prefix-consistent synthetic sequence), the others new
        n_batch = min(BATCH_SCANS, args.scans)
        batch_jobs = [pool.submit(make_sequence, n_batch, vlp16(), seed=seed,
                                  noise=0.01, speed=1.2)
                      for seed in BATCH_SEEDS[1:]]
        drive_jobs = [pool.submit(drive_chunk, k,
                                  min(k + DRIVE_CHUNK, DRIVE_SCANS))
                      for k in range(0, DRIVE_SCANS, DRIVE_CHUNK)]
        n_sessions = sum(SESSIONS)
        session_jobs = [pool.submit(session_chunk, k,
                                    min(k + SESSION_CHUNK, n_sessions),
                                    *SESSIONS)
                        for k in range(0, n_sessions, SESSION_CHUNK)]
        if args.long:
            jobs["stevens_check"] = pool.submit(
                make_sequence, DRIVE_CHECKED, vlp16(), seed=STEVENS_SEED,
                noise=0.01, trajectory="figure8")
            stevens_jobs = [pool.submit(stevens_chunk, k,
                                        min(k + STEVENS_CHUNK,
                                            STEVENS_PERIOD))
                            for k in range(0, STEVENS_PERIOD, STEVENS_CHUNK)]

        kernels.build(force=True, verbose=True)
        kernels.lib()
        t0 = time.time()
        feeder = hostlib.build()
        emit({"phase": "build", "library": os.path.relpath(
                  os.path.join(kernels.build_dir(), "libkernels.so")),
              "seconds": kernels.build_seconds,
              "sources": list(kernels.SOURCES),
              "host_library": os.path.relpath(feeder),
              "host_library_seconds": time.time() - t0,
              "resources": kernel_resources(
                  "knn5_kernel", "label_cluster_kernel", "label_grid_kernel",
                  "noop_kernel")})
        semantics_phase(dev)
        knn_entry = knn_phase(dev)
        data = {k: j.result() for k, j in jobs.items()}
        data["drive"] = drive_sequence([j.result() for j in drive_jobs],
                                       data.pop("drive_check"))
        data["batch"] = [j.result() for j in batch_jobs]
        data["sessions"] = [scan for j in session_jobs
                            for scan in j.result()]
        if args.long:
            data["stevens"] = [j.result() for j in stevens_jobs]
    emit({"phase": "data", "seconds": time.time() - t_start,
          "workers": workers,
          "sequences": {"bench": dict(scans=args.scans, seed=args.seed,
                                      noise=0.01, speed=1.2),
                        "lap": dict(scans=LAP_SCANS, **LAP),
                        "small_lap": dict(scans=SMALL_LAP_SCANS,
                                          **SMALL_LAP),
                        "drive": dict(scans=DRIVE_SCANS, **DRIVE,
                                      chunk=DRIVE_CHUNK,
                                      checked_against_make_sequence=
                                      DRIVE_CHECKED),
                        "batch": [dict(scans=n_batch, seed=seed, noise=0.01,
                                       speed=1.2) for seed in BATCH_SEEDS],
                        "sessions": dict(scans=list(SESSIONS),
                                         seed=SESSION_SEED,
                                         gap_s=SESSION_GAP_S),
                        **({"stevens": dict(scans=STEVENS_PERIOD,
                                            seed=STEVENS_SEED,
                                            trajectory="figure8")}
                           if args.long else {})}})

    floor = launch_floor_phase()
    knn_entry["launch_floor_ms"] = floor
    scans, gt, times = bench = data.pop("bench")
    entries = [label_phase(scans, cfg, dev, floor), knn_entry]
    parity_phase(dev)
    paths = {}
    paths["slice"] = slice_phase(scans, gt, times, cfg, dev)
    lap = data.pop("lap")
    paths["loop"], state, loop_outs, loop_result = loop_phase(lap, dev)
    resolve_phase(state, dev)
    stage1_graphs_phase(lap, dev)
    stage2_graphs_phase(lap, dev)
    stage3_graphs_phase(lap, dev)
    loop_meta = state.mapping.meta
    # what the full lap's replay(mesh=…) in `sharded` is held to, off the card
    loop_run = {"tree": convert.to_numpy_tree(state),
                "outs": {k: o.cpu() for k, o in loop_outs.items()},
                "scans_per_s": loop_result["scans_per_s"],
                "host_syncs": loop_result["host_syncs"],
                "launches": dict(paths["loop"])}
    del state, loop_outs
    torch.cuda.empty_cache()
    small_lap = data.pop("small_lap")
    loop_parity_phase(small_lap, dev)
    cli_phase(bench, dev)
    paths["streaming"] = streaming_phase(bench, dev)
    paths["odometry"] = odometry_phase(bench, dev)
    paths["multisession"] = multisession_phase(data.pop("sessions"), dev)
    torch.cuda.empty_cache()
    drive = data.pop("drive")
    paths["hdl64"] = hdl64_phase(drive, dev)
    torch.cuda.empty_cache()
    paths["banded"] = banded_phase(drive, dev)
    torch.cuda.empty_cache()
    streams = [tuple(a[:n_batch] for a in bench)] + data.pop("batch")
    paths["batched"], batched_outs = batched_phase(streams, dev)
    paths["sharded"], paths["sharded_mesh_lap"] = sharded_phase(
        streams, batched_outs, loop_meta, small_lap, lap, loop_run, dev)
    del loop_run
    del batched_outs
    torch.cuda.empty_cache()
    multihost_phase(dev)
    if args.long:
        paths["stevens"], paths["stevens_mesh"] = stevens_phase(
            data.pop("stevens"), data.pop("stevens_check"), dev)
        torch.cuda.empty_cache()
        scaling_phase(dev)
    del drive, lap, loop_meta
    for e in entries:
        # odometry-only runs no mapping, so no 5-NN search
        by_path = {path: counts[e["name"]] for path, counts in paths.items()
                   if e["name"] in counts}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        for path, count in by_path.items():
            if count < 1:
                raise AssertionError(f"{e['name']} never launched on the "
                                     f"{path} path")
    emit({"phase": "done", "seconds": time.time() - t_start})
    emit({"kernels": entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

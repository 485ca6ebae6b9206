"""Command-line entry point of the PyTorch/CUDA port — the ``roslaunch
lego_loam_bor run.launch rosbag:=…`` equivalent (``main.cpp:11-112``,
``launch/run.launch``), with the JAX package's flags and artifacts.

Input: an ``.npz`` sequence, a ROS1 ``.bag`` of ``sensor_msgs/PointCloud2``
(``--topic`` picks one; ``io/rosbag.py``), or ``--synthetic N`` scans.
A warm-up replay of at most 10 scans comes first (the first calls allocate
and, on the card, build the kernels).  Then, offline (default), the timed
replay of the whole sequence; with ``--streaming``, the live-topic mode:
a producer thread sends the scans through the native bounded channel
(``io/native_feeder.py``, depth 1 ⇒ lock-step) and the loop runs one
``slam_step`` per received scan, reads its fused pose on the host, and
every ``--publish-every`` mapping cycles writes the map artifacts with the
suffix ``_live``.  Both modes give the same poses bit for bit.  Then the
artifact set (TUM trajectories, the 2-D occupancy grid as PGM, the global
map, keyframe poses, ``metrics.json``).  Runs on the CUDA card unless
``--device cpu`` is given; without a card and without that flag it exits
with an error.  Loop closure is on, as in ``vlp16()``.

Examples:
  python -m lego_loam_tpu_torch.run --input seq.npz --output out/
  python -m lego_loam_tpu_torch.run --input run.bag --topic /velodyne_points --output out/
  python -m lego_loam_tpu_torch.run --synthetic 300 --output out/ --streaming
  python -m lego_loam_tpu_torch.run --synthetic 20 --output out/ --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .core import se3
from .core.config import vlp16
from .core.device import resolve_device
from .core.params import config_from_yaml
from .eval.artifacts import (StageTimer, dump_map_artifacts,
                             dump_run_artifacts, dump_scan_debug)
from .eval.metrics import ate
from .io.native_feeder import DeviceFeed, ScanChannel
from .io.npz_io import load_sequence, pack_raw_scan, pack_sequence
from .pipeline.slam import init_state, mapping_due, replay, slam_step

_WARMUP_SCANS = 10


def _log(msg: str) -> None:
    print(f"[lego-loam-torch] {msg}", file=sys.stderr)


def stream(scans, times, cfg, device: torch.device,
           output: Optional[str] = None, publish_every: int = 0,
           timer: Optional[StageTimer] = None):
    """The ``--streaming`` loop: scans go through a :class:`ScanChannel`
    (depth 1) from a producer thread, each received scan through one
    ``slam_step``; its fused pose is read on the host before the next
    ``recv``.  Every ``publish_every``-th mapping cycle (0: never) writes
    the map artifacts to ``output`` with the suffix ``_live``.

    Returns (final state, outputs dict of (N, …) tensors as ``replay``
    returns, per-scan latency in ms from ``recv`` to the fused pose on the
    host, per-scan bool "this scan ran a mapping cycle")."""
    channel = ScanChannel(cfg.pipeline.max_points, depth=1)

    def produce():
        try:
            for pts, stamp in zip(scans, times):
                if not channel.send(pts, float(stamp)):
                    return
        finally:
            channel.close()

    producer = threading.Thread(target=produce, daemon=True)
    feed = DeviceFeed(channel, device)
    state = init_state(cfg, device)
    outs, latency_ms, mapped = [], [], []
    publish_scans = publish_every * cfg.mapping.mapping_frequency_divider
    producer.start()
    try:
        while True:
            t0 = time.perf_counter()
            raw = feed.recv()
            if raw is None:
                break
            mapped.append(mapping_due(state.scan_index, cfg))
            state, out = slam_step(state, raw, cfg, device=device)
            out["fused"].cpu()                 # the pose a live user reads
            latency_ms.append(1e3 * (time.perf_counter() - t0))
            outs.append(out)
            if publish_scans and len(outs) % publish_scans == 0:
                t1 = time.perf_counter()
                dump_map_artifacts(output, state, cfg, suffix="_live")
                if timer is not None:
                    timer.add("publish_map", time.perf_counter() - t1)
    finally:
        channel.close()                        # stops a producer still sending
        producer.join()
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return state, stacked, latency_ms, mapped


def latency_summary(latency_ms, mapped, period_ms: float) -> dict:
    """p50 / p99 / max of the per-scan latency and the share of scans over
    the sensor period; p50 and that share also for mapping scans and the
    rest apart."""
    lat = np.asarray(latency_ms)
    is_map = np.asarray(mapped, bool)
    out = {"p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "max_ms": float(lat.max()), "period_ms": period_ms,
           "over_period_share": float(np.mean(lat > period_ms))}
    for name, sel in (("mapping", is_map), ("other", ~is_map)):
        if sel.any():
            out[f"p50_ms_{name}"] = float(np.percentile(lat[sel], 50))
            out[f"over_period_share_{name}"] = float(
                np.mean(lat[sel] > period_ms))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input",
                    help=".npz sequence (io.npz_io format) or ROS1 .bag "
                         "of sensor_msgs/PointCloud2")
    ap.add_argument("--topic", default=None,
                    help="PointCloud2 topic for .bag input (default: any; "
                         "the reference's lidar_topic param, main.cpp:21)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic scans instead of --input")
    ap.add_argument("--output", default="artifacts",
                    help="artifact directory")
    ap.add_argument("--config", help="reference-style YAML config")
    ap.add_argument("--odometry-only", action="store_true")
    ap.add_argument("--streaming", action="store_true",
                    help="per-scan streaming through the native channel")
    ap.add_argument("--publish-every", type=int, default=10, metavar="N",
                    help="streaming mode: emit map snapshots every Nth "
                         "mapping cycle (reference cadence: 10, "
                         "mapOptmization.cpp:1562-1568); 0 disables")
    ap.add_argument("--debug-scan", type=int, default=None, metavar="I",
                    help="also dump per-scan frontend debug clouds for "
                         "scan I (the reference's rviz topics, as .npz)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not (args.input or args.synthetic):
        ap.error("need --input or --synthetic")
    device = resolve_device(args.device)

    cfg = config_from_yaml(args.config) if args.config else vlp16()
    if args.odometry_only:
        cfg = cfg.replace(pipeline=dataclasses.replace(
            cfg.pipeline, odometry_only=True))

    timer = StageTimer()
    if args.synthetic:
        from .io.synthetic import make_sequence
        scans, gt, times = make_sequence(args.synthetic, cfg,
                                         seed=args.seed, noise=0.01)
    elif args.input.endswith(".bag"):
        from .io.rosbag import load_bag
        t0 = time.time()
        scans, gt, times = load_bag(args.input, topic=args.topic)
        timer.add("read_bag", time.time() - t0)
    else:
        scans, gt, times = load_sequence(args.input)
    n = len(scans)
    _log(f"{n} scans, device={device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    warm = min(_WARMUP_SCANS, n)
    xyz, valid, t = pack_sequence(scans[:warm], times[:warm], cfg,
                                  device=device)
    t0 = time.time()
    replay(xyz, valid, t, cfg, device=device)
    sync()
    timer.add("warmup", time.time() - t0)
    metrics = {}
    if args.streaming:
        t0 = time.time()
        final_state, outs, latency_ms, mapped = stream(
            scans, times, cfg, device, output=args.output,
            publish_every=args.publish_every, timer=timer)
        wall = time.time() - t0
        timer.add("streaming", wall)
        metrics["latency"] = latency_summary(
            latency_ms, mapped, 1e3 * cfg.laser.scan_period)
    else:
        xyz, valid, t = pack_sequence(scans, times, cfg, device=device)
        t0 = time.time()
        final_state, outs = replay(xyz, valid, t, cfg, device=device)
        sync()
        wall = time.time() - t0
        timer.add("replay", wall)

    rate = n / wall
    speed_x = rate * cfg.laser.scan_period
    _log(f"processed at {speed_x:.1f}X sensor speed ({rate:.1f} scans/s)")

    metrics.update({"scans_per_sec": round(rate, 2),
                    "realtime_factor": round(speed_x, 2),
                    "stages": timer.summary()})
    if not cfg.pipeline.odometry_only:
        meta = final_state.mapping.meta
        kf, factors = int(meta.kf_count), int(meta.factor_count)
        kf_drop = int(meta.kf_dropped)
        f_drop = int(meta.factor_dropped)
        m_sat = int(meta.map_sat)
        metrics["kf_dropped"] = kf_drop
        metrics["factor_dropped"] = f_drop
        metrics["map_voxel_sat"] = m_sat
        metrics["keyframes"] = kf
        metrics["factors"] = factors
        metrics["loop_factors"] = max(factors - max(kf - 1, 0), 0)
        if kf_drop or f_drop:
            _log(f"WARNING: capacity saturated — {kf_drop} keyframes / "
                 f"{f_drop} factors dropped; raise mapping.max_keyframes / "
                 f"max_loop_factors")
        if m_sat:
            _log(f"WARNING: world-frame voxel filters truncated {m_sat} "
                 f"voxels (map censored at an x-plane); raise "
                 f"mapping.max_map_corner/max_map_surf/loop_history_cap")
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    if gt is not None:
        g = torch.from_numpy(np.asarray(gt, np.float32))
        gt_rel = se3.relative(g[0], g).numpy()
        fused = outs["fused"]
        m = ate(fused[:-1], gt_rel[1:len(fused)], align=False)
        metrics["ate"] = m
        _log(f"ATE rmse {m['rmse']:.3f} m")

    dump_run_artifacts(args.output, outs, times, final_state, cfg,
                       gt_poses=gt, metrics=metrics)
    if args.debug_scan is not None:
        i = min(args.debug_scan, n - 1)
        raw = pack_raw_scan(scans[i], float(times[i]),
                            cfg.pipeline.max_points, device=device)
        path = dump_scan_debug(args.output, raw, cfg, index=i)
        _log(f"debug clouds -> {path}")
    print(json.dumps(metrics.get("ate", {"scans_per_sec": rate})))
    return 0


if __name__ == "__main__":
    sys.exit(main())

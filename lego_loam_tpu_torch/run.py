"""Command-line entry point of the PyTorch/CUDA port — the ``roslaunch
lego_loam_bor run.launch rosbag:=…`` equivalent (``main.cpp:11-112``,
``launch/run.launch``), with the JAX package's flags and artifacts.

Offline replay of a whole sequence: a warm-up replay of at most 10 scans
(the first calls allocate and, on the card, build the kernels), then the
timed replay of all of them; then the artifact set (TUM trajectories, the
2-D occupancy grid as PGM, the global map, keyframe poses, ``metrics.json``).
Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without that flag it exits with an error.  Loop closure is on, as in
``vlp16()``.

Not ported yet (``ROADMAP.md`` Queue A-5): ``--streaming`` and ``.bag``
input; asking for either exits non-zero.

Examples:
  python -m lego_loam_tpu_torch.run --input seq.npz --output out/
  python -m lego_loam_tpu_torch.run --synthetic 300 --output out/ --config cfg.yaml
  python -m lego_loam_tpu_torch.run --synthetic 20 --output out/ --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .core import se3
from .core.config import vlp16
from .core.device import resolve_device
from .core.params import config_from_yaml
from .eval.artifacts import StageTimer, dump_run_artifacts, dump_scan_debug
from .eval.metrics import ate
from .io.npz_io import load_sequence, pack_raw_scan, pack_sequence
from .pipeline.slam import replay

_NOT_PORTED = ("is not ported yet (ROADMAP.md Queue A-5: io/rosbag.py, "
               "io/native_feeder.py)")
_WARMUP_SCANS = 10


def _log(msg: str) -> None:
    print(f"[lego-loam-torch] {msg}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", help=".npz sequence (io.npz_io format)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic scans instead of --input")
    ap.add_argument("--output", default="artifacts",
                    help="artifact directory")
    ap.add_argument("--config", help="reference-style YAML config")
    ap.add_argument("--odometry-only", action="store_true")
    ap.add_argument("--streaming", action="store_true",
                    help="per-scan streaming through the native channel "
                         "(not ported yet)")
    ap.add_argument("--debug-scan", type=int, default=None, metavar="I",
                    help="also dump per-scan frontend debug clouds for "
                         "scan I (the reference's rviz topics, as .npz)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.streaming:
        ap.error(f"--streaming {_NOT_PORTED}")
    if args.input and args.input.endswith(".bag"):
        ap.error(f".bag input {_NOT_PORTED}")
    if not (args.input or args.synthetic):
        ap.error("need --input or --synthetic")
    device = resolve_device(args.device)

    cfg = config_from_yaml(args.config) if args.config else vlp16()
    if args.odometry_only:
        cfg = cfg.replace(pipeline=dataclasses.replace(
            cfg.pipeline, odometry_only=True))

    if args.synthetic:
        from .io.synthetic import make_sequence
        scans, gt, times = make_sequence(args.synthetic, cfg,
                                         seed=args.seed, noise=0.01)
    else:
        scans, gt, times = load_sequence(args.input)
    n = len(scans)
    _log(f"{n} scans, device={device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timer = StageTimer()
    xyz, valid, t = pack_sequence(scans, times, cfg, device=device)
    warm = min(_WARMUP_SCANS, n)
    t0 = time.time()
    replay(xyz[:warm], valid[:warm], t[:warm], cfg, device=device)
    sync()
    timer.add("warmup", time.time() - t0)
    t0 = time.time()
    final_state, outs = replay(xyz, valid, t, cfg, device=device)
    sync()
    wall = time.time() - t0
    timer.add("replay", wall)

    rate = n / wall
    speed_x = rate * cfg.laser.scan_period
    _log(f"processed at {speed_x:.1f}X sensor speed ({rate:.1f} scans/s)")

    metrics = {"scans_per_sec": round(rate, 2),
               "realtime_factor": round(speed_x, 2),
               "stages": timer.summary()}
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

"""The HDL-64 drive replayed on the CPU by the JAX package and by the port,
scan by scan.

Not a test module (pytest does not collect it): a whole run takes about
two hours on 8 CPU cores, most of it the JAX package's mapping cycles.
Run it by hand from the repository root:

    JAX_PLATFORMS=cpu python tests/hdl64_drive_parity.py [--scans 330]

Both packages replay ``benchmarks/kitti64_drive.py``'s sequence
(``hdl64()`` as shipped, seed 13, noise 0.01, 2 m/s on a 10 m circle, 330
scans: one lap and a revisit that closes a loop) in chunks of ``--chunk``
scans through ``replay_from``, the state carried from chunk to chunk; the
port runs with ``device="cpu"``.  Prints one JSON line: each side's ATE as
the benchmark takes it (estimate k against truth k+1, no alignment),
keyframes and loop factors, and the largest per-scan difference of the
two fused trajectories (translation in m, rotation in rad) with the scan
where it occurs.  ``--out`` also writes both fused trajectories.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lego_loam_tpu.core.config import hdl64 as jhdl64  # noqa: E402
from lego_loam_tpu.io.npz_io import pack_sequence as jpack  # noqa: E402
from lego_loam_tpu.io.synthetic import make_sequence  # noqa: E402
from lego_loam_tpu.pipeline import slam as jslam  # noqa: E402
from lego_loam_tpu_torch.core import se3  # noqa: E402
from lego_loam_tpu_torch.core.config import hdl64  # noqa: E402
from lego_loam_tpu_torch.eval.metrics import ate  # noqa: E402
from lego_loam_tpu_torch.io.npz_io import pack_sequence  # noqa: E402
from lego_loam_tpu_torch.pipeline import slam  # noqa: E402

# benchmarks/kitti64_drive.py:33-34, at N=330 as in KITTI64_r05.json
DRIVE = dict(seed=13, noise=0.01, speed=2.0, radius=10.0)


def _port(scans, times, chunk):
    cfg = hdl64()
    state = slam.init_state(cfg, "cpu")
    fused = []
    for s in range(0, len(scans), chunk):
        x, v, t = pack_sequence(scans[s:s + chunk], times[s:s + chunk], cfg,
                                device="cpu")
        state, outs = slam.replay_from(state, x, v, t, cfg, device="cpu")
        fused.append(outs["fused"].numpy())
        print(f"port: {s + len(x)} scans", file=sys.stderr, flush=True)
    meta = state.mapping.meta
    return np.concatenate(fused), int(meta.kf_count), int(meta.factor_count)


def _jax(scans, times, chunk):
    cfg = jhdl64()
    state = jslam.init_state(cfg)
    fused = []
    for s in range(0, len(scans), chunk):
        x, v, t = jpack(scans[s:s + chunk], times[s:s + chunk], cfg)
        state, outs = jslam.replay_from(state, x, v, t, cfg)
        fused.append(np.asarray(outs["fused"]))
        print(f"jax: {s + len(x)} scans", file=sys.stderr, flush=True)
    return (np.concatenate(fused), int(state.mapping.store.count),
            int(state.mapping.factor_count))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=330)
    ap.add_argument("--chunk", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help=".npz for both fused trajectories and the truth")
    args = ap.parse_args()
    t0 = time.time()
    scans, gt, times = make_sequence(args.scans, jhdl64(), **DRIVE)
    g = torch.from_numpy(np.asarray(gt, np.float32))
    gt_rel = se3.relative(g[0], g).numpy()
    result = {"scans": args.scans, "chunk": args.chunk,
              "generate_s": time.time() - t0,
              "torch_threads": torch.get_num_threads()}
    fused = {}
    for side, run in (("port", _port), ("jax", _jax)):
        t0 = time.time()
        f, kf, factors = run(scans, times, args.chunk)
        fused[side] = f
        result[side] = {"seconds": time.time() - t0,
                        "ate": ate(f[:-1], gt_rel[1:len(f)], align=False),
                        "keyframes": kf, "loop_factors": factors - (kf - 1)}
    d = np.abs(fused["port"] - fused["jax"])
    dt, dr = d[:, 3:].max(axis=1), d[:, :3].max(axis=1)
    result["max_fused_diff_m"] = float(dt.max())
    result["max_fused_diff_m_at_scan"] = int(dt.argmax())
    result["max_fused_diff_rad"] = float(dr.max())
    result["max_fused_diff_rad_at_scan"] = int(dr.argmax())
    if args.out:
        np.savez(args.out, port=fused["port"], jax=fused["jax"], gt=gt_rel)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

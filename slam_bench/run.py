"""The benchmark of ``lego_loam_tpu_torch``: one run of one cell.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Builds or loads the program's kernels
into ``build/`` of the checkout, makes the cell's inputs on the card from
the seed, warms up, measures for ``--seconds``, checks the outputs against
the plain reference (``slam_bench/reference/``), and prints one JSON object
as the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit (also the last lines of
standard error).  Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""

import time

_T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at fixed
# paths, so only a checkout's first run builds
os.environ.setdefault("LEGO_TORCH_BUILD_DIR", str(_REPO / "build"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_REPO / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(_REPO / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the port drives the card from one Python
# thread, and CPU thread pools that spin beside it only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "lego_loam_tpu")


def process_age_s() -> float:
    """Seconds from this process's creation to now (Linux), so that
    ``setup_s`` counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_START -= process_age_s() - (time.perf_counter() - _T_START)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _plain(v: float):
    """A number as strict JSON has it: a non-finite one as its name."""
    return v if v == v and abs(v) != float("inf") else repr(v)


def compose(res, cell, kind: str, traced: bool, seed: int, workload: str):
    """(earlier stdout lines, the result line, the check lines for standard
    error) of a run's result ``res`` (``harness.run_cell``)."""
    from slam_bench.peaks import PEAKS
    rec = res["records"]
    device_info = {"platform": "gpu", "kind": kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_info}
    earlier = []
    if traced:
        prof = rec.get("profile", {})
        device_info["busy_s"] = prof.get("busy_s", 0.0)
        device_info["window_s"] = prof.get("window_s", 0.0)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]

        line["breakdown"] = {
            "device_ops": top(prof.get("device_s_by_name", {})),
            "idle_gaps": top(prof.get("idle_s_by_host_op", {}))}
        earlier.append({"peaks": PEAKS.get(kind), "card": power_limit(),
                        "profiled_scans": prof.get("scans"),
                        "launches": prof.get("launches"),
                        "trace_s": prof.get("trace_s")})
    late = rec.get("sensor_late_ms")
    if late:
        import numpy as np
        late = np.asarray(late, float)
        earlier.append({"sensor_late_ms": {
            "p50": float(np.nanpercentile(late, 50)),
            "p95": float(np.nanpercentile(late, 95)),
            "max": float(np.nanmax(late))}})
    earlier.append({"seed": seed, "workload": workload,
                    "scans": rec["scans"], "window_s": rec["window_s"],
                    "setup_s": rec["setup_s"],
                    "values": {k: _plain(v) for k, v in res["values"].items()},
                    "host_reads": rec.get("host_reads"),
                    "timed_scans": rec.get("timed_scans"),
                    "chunk_scans_per_s": rec.get("chunk_scans_per_s")})
    line["checks"] = {c["name"]: {"value": _plain(c["value"]),
                                  "limit": c["limit"], "op": c["op"]}
                      for c in res["checks"]}
    check_lines = [
        f"check {c['name']} = {c['value']!r} {c['op']} {c['limit']!r}: "
        f"{'ok' if c['ok'] else 'FAILED'}" for c in res["checks"]]
    return earlier, line, check_lines


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from slam_bench.harness import Bench, run_cell

    torch.set_num_threads(1)
    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    seed = args.seed % (1 << 63)
    res = run_cell(bench, args.workload, seed, args.seconds,
                   bool(args.trace), device, _T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3

    earlier, line, check_lines = compose(res, cell, kind, bool(args.trace),
                                         args.seed, args.workload)
    for obj in earlier:
        print(json.dumps(obj))
    for text in check_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

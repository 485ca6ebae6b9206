"""Readings for the limits of the check, on several seeds of one cell in
one process: the program as its configuration states it (``float32``,
TF32 off), its control, and the faults planted for the numbers that the
control leaves alone:

- ``tf32`` (the control): every float32 matrix product with TF32 operands,
  the precision one step below the stated one (the program's own switch,
  plus the rounding, see :func:`tf32_products`);
- ``loop_z`` (a fault): each loop closure's ICP result moved 2 m, where
  the ICP returns it, so the loop factors measure the wrong motion;
- ``no_loop`` (a fault): loop closure off, where the configuration states
  it on;
- ``odometry_only`` (a fault): no mapping cycle, where the configuration
  states one every fifth scan.

    python3 slam_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--precision float32,tf32,loop_z,no_loop,odometry_only]

One JSON line per (precision, seed) with every number the check compares,
then a summary line.  The benchmark's own runs never run this;
``slam_bench/tests/test_slam_bench_card.py`` holds one control run to
``correct`` false on the card.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

import slam_bench.run  # noqa: E402,F401  (cache directories, as a run sets them)


_PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv",
             "einsum", "addmm", "baddbmm", "addbmm", "addmv", "tensordot"}


def to_tf32(x):
    """A float32 tensor rounded to TF32 (10 mantissa bits, to nearest, ties
    to even), as the tensor cores read a float32 operand."""
    import torch
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0x0FFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


def tf32_products():
    """A torch function mode that hands every float32 matrix product its
    operands in TF32: what the program's own switch
    (``torch.backends.cuda.matmul.allow_tf32``) asks for, applied to every
    product, since cuBLAS keeps its FFMA kernels at the program's shapes
    (inner sizes of 3 and batches of 3 x 3 and 6 x 6) and the switch alone
    leaves the arithmetic as it was."""
    from torch.overrides import TorchFunctionMode

    class TF32Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in _PRODUCTS:
                args = tuple([to_tf32(t) for t in a] if isinstance(a, (list, tuple))
                             else to_tf32(a) for a in args)
            return func(*args, **(kwargs or {}))

    return TF32Products()


def set_precision(precision: str) -> None:
    """``float32``: as the program's package sets it (TF32 off);
    ``tf32``: the program's TF32 switch on."""
    import torch
    import lego_loam_tpu_torch  # noqa: F401  (its import switches TF32 off)
    on = {"float32": False, "tf32": True}[precision]
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


LOOP_Z_SHIFT_M = 2.0


@contextlib.contextmanager
def loop_z_moved():
    """The loop ICP's correction moved ``LOOP_Z_SHIFT_M`` along x where
    ``loop/detect.py`` gets it, so every loop factor measures a motion that
    far off (the program's own plausibility gate, 3 m, still passes it)."""
    import torch
    from lego_loam_tpu_torch.loop import detect
    icp = detect.icp_align

    def moved(*args, **kwargs):
        corr, fitness, n_corr = icp(*args, **kwargs)
        shift = torch.zeros_like(corr)
        shift[3] = LOOP_Z_SHIFT_M
        return corr + shift, fitness, n_corr

    detect.icp_align = moved
    try:
        yield
    finally:
        detect.icp_align = icp


def _adjust(precision: str):
    def adjust(cfg):
        if precision == "no_loop":
            return cfg.replace(mapping=dataclasses.replace(
                cfg.mapping, enable_loop_closure=False))
        if precision == "odometry_only":
            return cfg.replace(pipeline=dataclasses.replace(
                cfg.pipeline, odometry_only=True))
        return cfg
    return adjust


def readings(workload: str, seeds, seconds: float, precision: str,
             device=None):
    """[(seed, result of ``harness.run_cell``)] for each seed."""
    import torch
    from slam_bench.harness import Bench, run_cell
    device = device or torch.device("cuda", 0)
    bench = Bench()
    out = []
    set_precision("tf32" if precision == "tf32" else "float32")
    try:
        for seed in seeds:
            mode = (tf32_products() if precision == "tf32"
                    else loop_z_moved() if precision == "loop_z"
                    else contextlib.nullcontext())
            with mode:
                res = run_cell(bench, workload, seed, seconds, False, device,
                               time.perf_counter(), _adjust(precision))
            res.pop("records")
            out.append((seed, res))
    finally:
        set_precision("float32")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--precision",
                   default="float32,tf32,loop_z,no_loop,odometry_only")
    p.add_argument("--dump", default=None,
                   help="directory for each run's outputs (.npz)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    for precision in args.precision.split(","):
        rows = readings(args.workload, seeds, args.seconds, precision)
        for seed, res in rows:
            if args.dump:
                import numpy as np
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                np.savez(Path(args.dump) / f"{args.workload}_{precision}_"
                         f"{seed}.npz", **res["outputs"])
            print(json.dumps({"precision": precision, "seed": seed,
                              "correct": res["correct"],
                              "scans": res["attempted"],
                              "values": res["values"]}), flush=True)
        for name in rows[0][1]["values"]:
            vals = [r["values"][name] for _, r in rows]
            summary.setdefault(precision, {})[name] = [min(vals), max(vals)]
    print(json.dumps({"workload": args.workload, "min_max": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

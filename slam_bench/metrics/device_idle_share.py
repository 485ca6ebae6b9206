"""Share of the profiled slice (host clock, synchronised at both ends) in
which no kernel or copy ran on the card (the union of the trace's device
intervals)."""

from slam_bench.metrics import _arith


def read(records):
    prof = records.get("profile")
    if not prof or not prof.get("busy_s"):
        return None
    return _arith.share(prof["window_s"] - prof["busy_s"], prof["window_s"])

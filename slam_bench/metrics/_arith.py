"""Operations, bytes and least times of the program's two hand-written
kernels, and the device shares of a profiled slice.

The counts are those ``chip_smoke.py`` (``knn_bound``, ``label_phase``)
states for the kernels' main-path calls: each input byte read once and each
output byte written once; K2 does 8 flops per valid (query, candidate)
pair.  Least time = the larger of operations / peak FLOP/s and bytes /
peak bytes/s, with the card's published peaks (``slam_bench/peaks.py``)."""

from typing import Dict, Optional

from slam_bench.peaks import PEAKS


def k2_bytes(Q: int, M: int) -> int:
    """One 5-NN search: Q query and M candidate points (float32 x 3 and a
    1-byte mask each) read, five (index, distance) pairs a query written."""
    return Q * 12 + Q + M * 12 + M + Q * 5 * 8


def k2_flops(valid_pairs: int) -> int:
    return 8 * valid_pairs


def k1_bytes(pixels: int) -> int:
    """One labelling: int32 seed labels and two 1-byte edge masks read,
    int32 labels written."""
    return pixels * (4 + 1 + 1 + 4)


def k1_ops(pixels: int) -> int:
    return 8 * pixels


def least_s(flops: float, n_bytes: float, peaks: Dict) -> float:
    return max(flops / peaks["fp32_flops_per_s"],
               n_bytes / peaks["hbm_bytes_per_s"])


def kernel_device_s(profile: Dict, *names: str) -> float:
    """Device seconds of the kernels whose trace name contains any of
    ``names``."""
    return sum(s for n, s in profile["device_s_by_name"].items()
               if any(k in n for k in names))


def peaks_of(records: Dict) -> Optional[Dict]:
    return PEAKS.get(records.get("device_kind"))


def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None

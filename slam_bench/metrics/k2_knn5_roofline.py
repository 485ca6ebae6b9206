"""K2's (``csrc/knn5.cu``) share of its roofline over the profiled slice:
the least time of the launches the slice made (each launch's larger of
8 flops a valid pair over the FP32 peak and its bytes over the HBM peak)
over the kernel's device time in the trace."""

from slam_bench.metrics import _arith


def read(records):
    prof, peaks = records.get("profile"), _arith.peaks_of(records)
    if not prof or not peaks or not prof.get("k2_bytes"):
        return None
    least = sum(_arith.least_s(_arith.k2_flops(p), b, peaks)
                for b, p in zip(prof["k2_bytes"], prof["k2_pairs"]))
    return _arith.share(least, _arith.kernel_device_s(prof, "knn5_kernel"))

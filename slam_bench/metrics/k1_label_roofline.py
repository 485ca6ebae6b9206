"""K1's (``csrc/label.cu``) share of its roofline over the profiled slice:
the least time of its launches (bytes-bound: the label image and two edge
masks read once, the labels written once) over the kernel's device time in
the trace."""

from slam_bench.metrics import _arith


def read(records):
    prof, peaks = records.get("profile"), _arith.peaks_of(records)
    if not prof or not peaks or not prof.get("k1_pixels"):
        return None
    least = sum(_arith.least_s(_arith.k1_ops(n), _arith.k1_bytes(n), peaks)
                for n in prof["k1_pixels"])
    return _arith.share(least, _arith.kernel_device_s(
        prof, "label_cluster_kernel", "label_grid_kernel"))

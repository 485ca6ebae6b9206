"""Host reads of device values (``core/device.py::sync_count``: one a
Gauss-Newton, ICP or PCG iteration, closure decision or gate) per timed
scan of the window, the profiled slice left out."""


def read(records):
    n = records.get("timed_scans")
    if not n or "stage_ms" not in records:
        return None
    return records["host_reads"] / n

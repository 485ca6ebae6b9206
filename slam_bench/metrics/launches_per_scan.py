"""Kernel launches (device kernel events of the trace, copies and memsets
left out) per scan of the profiled slice."""


def read(records):
    prof = records.get("profile")
    if not prof or not prof.get("scans") or not prof.get("busy_s"):
        return None
    return prof["launches"] / prof["scans"]

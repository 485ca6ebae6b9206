"""Milliseconds of one of the program's stages, from the CUDA events of
``core/device.py::stage(<name>)`` summed over the timed scans of the window
(the profiled slice left out): the stage's span on the stream's timeline,
host gaps inside it included."""


def per_scan(records, name):
    """The stage's milliseconds a timed scan."""
    ms = records.get("stage_ms", {}).get(name)
    n = records.get("timed_scans")
    if ms is None or not n:
        return None
    return ms / n


def per_cycle(records, name):
    """The stage's milliseconds a mapping cycle (every fifth scan)."""
    ms = records.get("stage_ms", {}).get(name)
    n = records.get("mapping_cycles")
    if ms is None or not n:
        return None
    return ms / n

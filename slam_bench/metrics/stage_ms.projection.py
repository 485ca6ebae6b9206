"""Milliseconds a scan in the program's ``projection`` stage (projection,
ground, segmentation with K1); see ``_stage.py``."""

from slam_bench.metrics._stage import per_scan


def read(records):
    return per_scan(records, "projection")

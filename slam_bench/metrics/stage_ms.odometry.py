"""Milliseconds a scan in the program's ``odometry`` stage (features and
scan-to-scan matching); see ``_stage.py``."""

from slam_bench.metrics._stage import per_scan


def read(records):
    return per_scan(records, "odometry")

"""Milliseconds a mapping cycle (every fifth scan: scan-to-map, keyframe
store, loop attempts and re-solves); see ``_stage.py``."""

from slam_bench.metrics._stage import per_cycle


def read(records):
    return per_cycle(records, "mapping")

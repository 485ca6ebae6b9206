"""50th percentile over every scan of the live window of the time from the
scan's due time on the sensor's schedule to its fused pose read on the
host (NumPy's linear interpolation between order statistics)."""

import numpy as np


def read(records):
    lat = records.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, float), 50))

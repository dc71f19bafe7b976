"""The 95th percentile (linear between order statistics) of every call of
the window, each timed from the call to its result on the host."""

import numpy as np


def read(record):
    lat = record.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3

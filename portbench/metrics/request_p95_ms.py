"""95th percentile of every window request's latency (host clock, from the
call to the waveform on the host), ms; a failed request counts as the
slowest."""

import numpy as np


def read(run):
    lat = [float("inf") if r.get("failed") else r["latency_s"]
           for r in run.requests]
    return float(np.percentile(lat, 95)) * 1e3

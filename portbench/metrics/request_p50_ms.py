"""Median latency of the window's requests, ms: the steadier companion of
the 95th percentile, through the vocoder's entry point."""

import numpy as np


def read(run):
    lat = [float("inf") if r.get("failed") else r["latency_s"]
           for r in run.requests]
    return float(np.percentile(lat, 50)) * 1e3

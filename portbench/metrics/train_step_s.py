"""Seconds per optimiser step: the window over the steps it completed."""


def read(run):
    steps = sum(r.get("steps", 0) for r in run.requests if not r.get("failed"))
    return run.window_s / steps if steps else None

"""Device ms of the work launched inside each optimiser step of the traced
segment (the D and G phases, the losses, the frontends, the updates)."""


def read(run):
    steps = sum(r.get("steps", 0) for r in run.segment if not r.get("failed"))
    if run.trace is None or not steps:
        return None
    seconds = run.trace.seconds_inside("request")
    return seconds * 1e3 / steps if seconds > 0 else None

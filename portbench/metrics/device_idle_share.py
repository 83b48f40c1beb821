"""% of the untraced window's wall time in which the device had no work:
1 - (device busy seconds per unit of work in the traced segment) / (wall
seconds per unit of work in the window), the unit a second of audio served
or an optimiser step.  The profiler lengthens the traced segment's wall
(host overhead) but not its device time, so the busy time comes from the
trace and the wall from the untraced window."""


def read(run):
    if run.trace is None:
        return None
    key = "audio_s" if any("audio_s" in r for r in run.requests) else "steps"
    window = sum(r[key] for r in run.requests if not r.get("failed"))
    segment = sum(r[key] for r in run.segment if not r.get("failed"))
    if not window or not segment:
        return None
    busy_per_unit = run.trace.busy_s / segment
    wall_per_unit = run.window_s / window
    return 100.0 * (1.0 - busy_per_unit / wall_per_unit)

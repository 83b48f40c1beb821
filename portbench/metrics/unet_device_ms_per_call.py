"""Device ms of the work launched inside the UNet's forward, per call, in
the traced segment."""


def read(run):
    calls = run.segment_counters.get("unet", 0)
    if run.trace is None or not calls:
        return None
    seconds = run.trace.seconds_inside("unet")
    return seconds * 1e3 / calls if seconds > 0 else None

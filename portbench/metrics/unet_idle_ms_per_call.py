"""Device idle ms while the program's ``unet`` span is the innermost open on
the host, per call, in the traced segment (the profiler's own host cost
lengthens it)."""

from portbench import program_spans


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["unet"]:
        return None
    return spans.idle_ms_by_innermost().get("unet", 0.0) / spans.counts[
        "unet"]

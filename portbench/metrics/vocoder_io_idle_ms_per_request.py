"""Device idle ms while the program's ``vocoder`` span or its host work
(``vocoder.pad``, ``vocoder.to_device``, ``vocoder.to_host``) is the
innermost span open on the host, per request, in the traced segment (the
profiler's own host cost lengthens it)."""

from portbench import program_spans

IO = ("vocoder", "vocoder.pad", "vocoder.to_device", "vocoder.to_host")


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["vocoder"]:
        return None
    idle = spans.idle_ms_by_innermost()
    return sum(idle.get(name, 0.0) for name in IO) / spans.counts["vocoder"]

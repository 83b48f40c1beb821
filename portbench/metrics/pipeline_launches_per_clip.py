"""Device activities launched inside the program's ``pipeline`` span but
outside its ``sampler.step`` and ``generator`` spans, per clip, in the
traced segment: windows, stitch and the pipeline's own glue."""

from portbench import program_spans


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["pipeline"]:
        return None
    return len(spans.launched("pipeline", ("sampler.step", "generator"))) / (
        spans.counts["pipeline"])

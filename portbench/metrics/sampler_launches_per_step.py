"""Device activities launched inside the program's ``sampler.step`` span but
outside its ``unet`` call, per step, in the traced segment: the sampler's
own update and time condition."""

from portbench import program_spans


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["sampler.step"]:
        return None
    return len(spans.launched("sampler.step", ("unet",))) / spans.counts[
        "sampler.step"]

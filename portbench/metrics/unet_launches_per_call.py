"""Device activities launched inside the program's ``unet`` span (one call
of the denoiser), per call, in the traced segment: the host's launch work
per UNet call."""

from portbench import program_spans


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["unet"]:
        return None
    return len(spans.launched("unet")) / spans.counts["unet"]

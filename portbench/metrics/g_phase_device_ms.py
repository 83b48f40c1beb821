"""Device ms launched inside the program's ``stage2.g_phase`` span (the mel
and adversarial losses, the generator's gradient, clip and AdamW), per
``stage2.step``, in the traced segment."""

from portbench import program_spans


def read(run):
    spans = program_spans.read(run)
    if spans is None or not spans.counts["stage2.step"]:
        return None
    return spans.device_ms("stage2.g_phase") / spans.counts["stage2.step"]

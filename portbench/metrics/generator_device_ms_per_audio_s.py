"""Device ms launched inside the generator's forward per second of audio
the traced segment delivered."""


def read(run):
    audio = sum(r["audio_s"] for r in run.segment if not r.get("failed"))
    if run.trace is None or not audio:
        return None
    seconds = run.trace.seconds_inside("generator")
    return seconds * 1e3 / audio if seconds > 0 else None

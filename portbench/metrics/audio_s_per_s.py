"""Seconds of audio served per wall second: all the window's requests over
the whole window (``.clip``: whole clips; ``.vocode``: utterances)."""


def read(run):
    return sum(r["audio_s"] for r in run.requests
               if not r.get("failed")) / run.window_s

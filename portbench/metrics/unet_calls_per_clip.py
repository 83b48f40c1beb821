"""UNet calls per served clip in the window, counted by a forward hook on
the port's denoiser: the sampler's steps times its groups of windows."""


def read(run):
    clips = sum(1 for r in run.requests if not r.get("failed"))
    return run.window_counters.get("unet", 0) / clips if clips else None

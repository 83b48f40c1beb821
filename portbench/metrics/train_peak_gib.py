"""The allocator's peak over the window's steps (``max_memory_allocated``
after a reset at the window's start), GiB: the memory a batch needs."""


def read(run):
    return run.window_peak_bytes / 2 ** 30

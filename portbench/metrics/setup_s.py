"""Seconds from the process's start to the first timed request: imports,
weights made on the card, kernels loaded, the cell's shapes warmed."""


def read(run):
    return run.setup_s

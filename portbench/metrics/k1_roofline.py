"""K1, the float32 self-attention kernels at n >= 1024 tokens (the forward
and its pre-passes), as a share of the attention's roofline."""

from portbench.roofline import share


def read(run):
    return share(run, "k1")

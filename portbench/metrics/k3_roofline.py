"""K3, the float32 fused snake -> convolution kernels (the product and its
weight pre-pass), as a share of the convolution's roofline."""

from portbench.roofline import share


def read(run):
    return share(run, "k3")

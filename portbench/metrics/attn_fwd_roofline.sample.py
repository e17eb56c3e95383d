"""The attention forward kernels' share of their roofline over the window,
in percent (``roofline.py:kernel_share``)."""

from portbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "fwd", "attn_fwd")

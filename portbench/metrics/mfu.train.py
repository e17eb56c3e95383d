"""The train steps' model FLOPs (forward and backward, no recompute,
``counters/film.py``) over the window's wall and the peak of the compute
dtype, in percent."""

from portbench.roofline import model_share


def read(run):
    return model_share(run, "train_step")

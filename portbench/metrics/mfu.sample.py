"""All model FLOPs of the window's calls (keyframes, encode, both guidance
branches at every DDIM step; ``counters/film.py``) over the window's wall
and the peak of the compute dtype, in percent."""

from portbench.roofline import model_share


def read(run):
    if "calls" not in run.work:
        return None
    return model_share(run)

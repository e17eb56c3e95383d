"""Training clips completed per second: steps x batch over the window's wall."""


def read(run):
    if "samples" not in run.work or run.seconds <= 0:
        return None
    return run.work["samples"] / run.seconds

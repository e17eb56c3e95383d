"""The conditioning's wall (lip vertices and encode, the device
synchronised at both ends) over the window's, in percent."""


def read(run):
    if "encode" not in run.spans or run.seconds <= 0:
        return None
    return 100.0 * run.spans["encode"] / run.seconds

"""The keyframer's wall (the device synchronised at both ends) over the
window's, in percent."""


def read(run):
    if "keyframer" not in run.spans or run.seconds <= 0:
        return None
    return 100.0 * run.spans["keyframer"] / run.seconds

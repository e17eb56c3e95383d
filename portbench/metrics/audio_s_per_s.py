"""Seconds of input audio whose output the window completed, over the
window's wall: whole calls back to back until the window's length has
passed, divided by the time to the end of the last call."""


def read(run):
    if "audio_s" not in run.work or run.seconds <= 0:
        return None
    return run.work["audio_s"] / run.seconds

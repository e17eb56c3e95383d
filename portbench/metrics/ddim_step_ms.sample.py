"""The window's DDIM wall (the device synchronised at both ends of each
loop) over all its DDIM steps, in milliseconds."""


def read(run):
    if "ddim" not in run.spans or not run.work.get("ddim_steps"):
        return None
    return 1e3 * run.spans["ddim"] / run.work["ddim_steps"]

"""Device kernel launches per DDIM step, counted in the profiler's trace
over the DDIM loops of the window."""


def read(run):
    if run.trace is None or "ddim" not in run.trace.launches_in or not run.work.get("ddim_steps"):
        return None
    return run.trace.launches_in["ddim"] / run.work["ddim_steps"]

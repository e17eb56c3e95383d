"""Process start to the first timed call: imports, the CUDA context, the
kernels' libraries, weights, synthetic data, the warm-up of the cell's own
shapes."""


def read(run):
    return run.setup_s

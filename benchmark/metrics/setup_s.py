"""Process start to the first timed pair: imports, the CUDA context, the
kernels (built on a checkout's first run), the frames and the warm-up
pair."""


def read(run):
    return run.setup_s

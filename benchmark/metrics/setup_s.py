"""End to end: process start to the first timed request (loading the
weights, the port's quantization, the kernels' builds, the warm-up
captures)."""


def read(run):
    return run.setup_s

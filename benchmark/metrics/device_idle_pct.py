"""Device: the share of the profiled image's wall time in which no device
event (kernel, copy or set) ran."""


def read(run):
    if run.trace is None:
        return None
    wall = run.traced["wall_s"]
    return 100.0 * max(wall - run.trace["busy_s"], 0.0) / wall

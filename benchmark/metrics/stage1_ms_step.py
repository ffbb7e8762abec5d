"""Stage 1 loop: the window's Stage-1 seconds over its SR3 steps, in ms
(the pipeline's synchronised `timings["stage1"]`)."""


def read(run):
    steps = run.spec["stage1"]["steps"] * len(run.images)
    return 1e3 * sum(r["timings"]["stage1"] for r in run.images) / steps

"""Stage 2b loop: the mean seconds of RestoreEDM's 50 steps
(`timings["sampling"]`)."""


def read(run):
    return sum(r["timings"]["sampling"] for r in run.images) / len(run.images)

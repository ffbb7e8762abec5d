"""Stage 2b loop: the share of RestoreEDM steps the first-block cache
served (hits over steps of the window, `last_dfb`)."""


def read(run):
    steps = sum(r["dfb"]["steps"] for r in run.images)
    return 100.0 * sum(r["dfb"]["hits"] for r in run.images) / steps

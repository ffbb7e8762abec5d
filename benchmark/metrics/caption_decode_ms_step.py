"""Caption: the window's decode seconds over its decode steps, in ms."""


def read(run):
    stats = [r["caption_stats"] for r in run.images if r["caption_stats"]]
    steps = sum(s["decode_steps"] for s in stats)
    if not steps:
        return None
    return 1e3 * sum(s["decode_s"] for s in stats) / steps

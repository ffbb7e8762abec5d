"""End to end: the card's peak allocated memory over the warm-up and the
window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

"""End to end: the window's wall seconds over the whole images it
completed (the window runs to the end of the image in flight)."""


def read(run):
    return run.window_s / len(run.images)

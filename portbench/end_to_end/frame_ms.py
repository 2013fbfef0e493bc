"""Milliseconds per frame: the window's length over the frames completed
in it, so a stall counts in full."""


def read(run):
    if not run.completed:
        return None
    return run.seconds * 1000.0 / run.completed

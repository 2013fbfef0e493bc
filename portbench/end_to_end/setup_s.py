"""Seconds from the start of the process to the window: imports, the
cells, the Renderer, the kernels' build where the checkout has none, and
the warm-up frames."""


def read(run):
    return run.setup_s

"""``torch.cuda.max_memory_allocated()`` over set-up and window, in MB
(10^6 bytes)."""


def read(run):
    return run.peak_bytes / 1e6

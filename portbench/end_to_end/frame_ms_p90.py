"""The 90th percentile of the host times of the frames completed in the
window, in ms (``statistics.quantiles``, inclusive)."""

import statistics


def read(run):
    times = run.frame_s[:run.completed]
    if len(times) < 10:
        return None
    return 1000.0 * statistics.quantiles(times, n=10,
                                         method="inclusive")[-1]

"""The device's idle share of the traced stretch: 100 minus the union of
its operations' intervals over the stretch's length on the host's clock,
in %."""


def read(trace):
    if trace.window_s <= 0 or not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)

"""K6's share of its roofline over the traced stretch, in %: the sum over
its launches of each launch's bound (bytes and operations of
``yardstick.k6_counts``) over the sum of its launches' device time.  The
arguments are taken where ``render/slabs.py`` calls the kernel, through
its ``xresample_mids_levels``."""

from portbench.yardstick import bound_s, k6_counts, port_kernel

TAP = ("owlexabrick_tpu_torch.render.slabs", "xresample_mids_levels")


def record(args, kwargs, out):
    return k6_counts(args[0], args[1], out)


def read(trace):
    calls = trace.calls.get("k6_roofline_pct", [])
    dev_s = sum(e.dur_ns for e in trace.events
                if port_kernel(e.name) == "K6") / 1e9
    if not calls or dev_s <= 0:
        return None
    return 100.0 * sum(bound_s(b, o) for b, o in calls) / dev_s

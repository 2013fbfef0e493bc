"""Device milliseconds per frame of every kernel that is not one of the
port's hand-written kernels (by profiler name, ``yardstick.PORT_KERNELS``):
the eager torch work around them, such as the camera products' z lerp,
the activity and stride tables and accumulation (copies and fills not
counted)."""

from portbench.yardstick import port_kernel


def read(trace):
    ns = sum(e.dur_ns for e in trace.events
             if e.is_kernel and port_kernel(e.name) is None)
    if not trace.frames or not ns:
        return None
    return ns / 1e6 / trace.frames

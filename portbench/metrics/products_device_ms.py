"""Device milliseconds per frame of the camera products
(``render/slabs.py::mega_chunk_products``: the z lerp, K6 and the
TF-cull rows): the device events whose start lies inside one of the
program's ``products`` spans, over the frames traced.  The card idles
most of the time, so an operation starts almost as soon as it is
launched, inside the span that launched it."""

from portbench.program_spans import device_ns_started_in, frames_session


def read(trace):
    from owlexabrick_tpu_torch.utils import profiling

    s = frames_session(trace, profiling)
    if s is None:
        return None
    ns = device_ns_started_in(s, "products", trace.events)
    if not ns:
        return None
    return ns / 1e6 / trace.frames

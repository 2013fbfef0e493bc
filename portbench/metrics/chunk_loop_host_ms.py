"""Host milliseconds per frame of the chunk loop's own work
(``render/slabs.py::render_slabs``, the program's ``chunk`` spans): their
self time, less the camera products, the tile and activity tables, K1's
launch and the host syncs inside them, over the frames traced."""

from portbench.program_spans import frames_session, self_ns


def read(trace):
    from owlexabrick_tpu_torch.utils import profiling

    s = frames_session(trace, profiling)
    if s is None:
        return None
    return self_ns(s, "chunk") / 1e6 / trace.frames

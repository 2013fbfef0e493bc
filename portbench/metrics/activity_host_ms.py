"""Host milliseconds per frame of the per-frame activity tables
(``render/sweep.py::combine_activity``, the program's ``activity``
spans): their self time, less the host syncs inside them, over the
frames traced."""

from portbench.program_spans import frames_session, self_ns


def read(trace):
    from owlexabrick_tpu_torch.utils import profiling

    s = frames_session(trace, profiling)
    if s is None:
        return None
    return self_ns(s, "activity") / 1e6 / trace.frames

"""Host milliseconds per frame spent blocked on the card: the summed
duration of the program's ``sync.<site>`` spans over the traced frames,
over the frames traced."""

from portbench.program_spans import frames_session, total_ns


def read(trace):
    from owlexabrick_tpu_torch.utils import profiling

    s = frames_session(trace, profiling)
    if s is None:
        return None
    return total_ns(s, "sync.") / 1e6 / trace.frames

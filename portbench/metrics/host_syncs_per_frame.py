"""Places per frame where the host waited for the card: the sum of the
program's ``sync.<site>`` counter deltas over the traced frames (a read
back, or a copy from pageable host memory, which drains the stream),
over the frames traced."""

from portbench.program_spans import frames_session


def read(trace):
    from owlexabrick_tpu_torch.utils import profiling

    s = frames_session(trace, profiling)
    if s is None:
        return None
    n = sum(v for f in s.frames for k, v in f.counts.items()
            if k.startswith("sync."))
    return n / trace.frames

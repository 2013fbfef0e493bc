"""Reading the program's own spans and counters
(``owlexabrick_tpu_torch.utils.profiling``): the session the traced
stretch recorded, each span's self time, and which device events
started inside spans of a name.  A program without them (``session``
absent) gives None, so its metrics are left out of the line."""

from __future__ import annotations

import bisect


def frames_session(trace, profiling):
    """The program's last profiler session, where it holds one ``frame``
    record per traced frame; else None."""
    session = getattr(profiling, "session", None)
    if session is None or not trace.frames:
        return None
    s = session()
    return s if len(s.frames) == trace.frames else None


def durations(s):
    """Per span its closed duration, ns (0 while open)."""
    return [max(0, sp.end_ns - sp.start_ns) if sp.end_ns else 0
            for sp in s.spans]


def self_ns(s, name: str) -> int:
    """The summed self time of the spans named ``name``: each span's
    duration less the durations of its children."""
    dur = durations(s)
    children = [0] * len(s.spans)
    for i, sp in enumerate(s.spans):
        if sp.parent >= 0:
            children[sp.parent] += dur[i]
    return sum(dur[i] - children[i] for i, sp in enumerate(s.spans)
               if sp.name == name)


def total_ns(s, prefix: str) -> int:
    """The summed duration of the spans whose name starts with
    ``prefix``."""
    dur = durations(s)
    return sum(dur[i] for i, sp in enumerate(s.spans)
               if sp.name.startswith(prefix))


def device_ns_started_in(s, name: str, events) -> int:
    """Device time of the ``events`` whose start lies inside a span
    named ``name`` (spans of one name do not overlap)."""
    spans = sorted((sp.start_ns, sp.end_ns) for sp in s.spans
                   if sp.name == name and sp.end_ns)
    starts = [a for a, _ in spans]
    total = 0
    for e in events:
        i = bisect.bisect_right(starts, e.start_ns) - 1
        if i >= 0 and e.start_ns <= spans[i][1]:
            total += e.dur_ns
    return total

"""Tracing/profiling utilities (the port of
``owlexabrick_tpu/utils/profiling.py``).

The reference offers: a per-pixel clock-cycle heat map (clockScale,
exabrick.cu:1588/1703-1707), an FPS title bar + 50-frame benchmark average
(viewer.cpp:297-339), preprocessing wall-clock prints, and memory usage
printouts.  Equivalents here:

  * ``FrameStats`` — the 50-frame benchmark average
  * ``cost_heatmap`` — per-ray traversal-iteration counts from the exact
    march mapped to the red channel (the clock-scale analog;
    deterministic instead of clock-based)
  * ``counts`` / ``count`` — one registry of cumulative integers, always
    on: the hand-written kernels' launches (``launch.K1`` ...), the
    places the host waits for the card (``sync.<site>``), the camera-
    product cache tier that served each chunk swept (``cache.full``,
    ``cache.light``: its mids rebuilt, ``cache.none``: built from
    scratch), the bytes of mids the camera products built
    (``products.mid_bytes``), and the megakernel lane's early exit, which
    never waits: the frames its device flag ended (``exit.flagged``)
    and the chunks launched from the flagged one on, which K1 turned
    into no-ops (``exit.late_chunks``)
  * ``span`` / ``frame`` / ``sync`` / ``in_span`` — named spans of the
    fast path on the host's wall clock (``time.time_ns()``, the clock
    ``torch.profiler``'s device events are stamped on), recorded only
    while a ``torch.profiler`` session is active; ``session()`` returns
    the most recent session's frames, spans and counter deltas
"""

from __future__ import annotations

import collections
import functools
import time
from typing import List, Optional

import numpy as np
import torch


class FrameStats:
    """Benchmark average (exa/viewer.cpp:297-339)."""

    def __init__(self, bench_frames: int = 50):
        self.bench_frames = bench_frames
        self.reset()

    def reset(self):
        self.t_last = None
        self.frame_times = []

    def tick(self) -> Optional[str]:
        now = time.time()
        msg = None
        if self.t_last is not None:
            self.frame_times.append(now - self.t_last)
            if len(self.frame_times) == self.bench_frames:
                avg = sum(self.frame_times) / len(self.frame_times)
                msg = (
                    f"#exa: bench avg over {self.bench_frames} frames: "
                    f"{1.0/avg:.2f} FPS ({avg*1e3:.1f} ms/frame)"
                )
        self.t_last = now
        return msg


def cost_heatmap(iters: np.ndarray, scale: float = 0.05) -> np.ndarray:
    """Map per-ray iteration counts to [0,1] red-channel intensities, like
    the clock heat map's clockScale (exabrick.cu:1703-1707)."""
    return np.clip(np.asarray(iters, np.float32) * scale, 0.0, 1.0)


# -- counters ---------------------------------------------------------------

# name -> cumulative count since the process started; read a stretch's
# count as the difference of two snapshots (``dict(counts)``)
counts = collections.defaultdict(int)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    counts[name] += n


# -- spans ------------------------------------------------------------------

# whether a torch.profiler session (any activities) is recording
_profiling = torch._C._autograd._profiler_enabled


class SpanRecord:
    """One span: its name, the index of its frame in ``Session.frames``
    (-1 outside a frame), its parent's index in ``Session.spans`` (-1 for
    a root), and ``time.time_ns()`` at open and close (0 while open)."""

    __slots__ = ("name", "frame", "parent", "start_ns", "end_ns")

    def __init__(self, name, frame, parent, start_ns):
        self.name, self.frame, self.parent = name, frame, parent
        self.start_ns, self.end_ns = start_ns, 0

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, frame={self.frame}, "
                f"parent={self.parent}, {self.start_ns}, {self.end_ns})")


class FrameRecord:
    """One ``frame`` span: the caller's frame id, the index of its span,
    and the counters' nonzero deltas from its open to its close."""

    __slots__ = ("id", "span", "counts")

    def __init__(self, frame_id, span):
        self.id, self.span, self.counts = frame_id, span, {}


class Session:
    """The spans of one profiler session, in the order they opened."""

    def __init__(self):
        self.frames: List[FrameRecord] = []
        self.spans: List[SpanRecord] = []
        self._stack: List[int] = []  # open spans, innermost last
        self._frame = -1  # the open frame's index


_session = Session()
_live = False  # whether _session is still the profiler's


def session() -> Session:
    """The most recent profiler session's records (empty before any).
    Read after the profiler stopped, it stays until a span opens under
    the next session."""
    if _live and not _profiling():
        _close()
    return _session


def _close():
    """The profiler stopped: the next span under one starts a session."""
    global _live
    _live = False


def _current() -> Session:
    global _session, _live
    if not _live:
        _session, _live = Session(), True
    return _session


class _Noop:
    """The span returned while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "session", "index")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        s = self.session = _current()
        self.index = len(s.spans)
        s.spans.append(SpanRecord(self.name, s._frame,
                                  s._stack[-1] if s._stack else -1,
                                  time.time_ns()))
        s._stack.append(self.index)
        return self

    def __exit__(self, *exc):
        s = self.session
        s.spans[self.index].end_ns = time.time_ns()
        s._stack.pop()
        return False


class _Frame(_Span):
    __slots__ = ("frame_id", "record", "outer", "counts0")

    def __init__(self, frame_id):
        super().__init__("frame")
        self.frame_id = frame_id

    def __enter__(self):
        super().__enter__()
        s = self.session
        self.outer = s._frame
        s._frame = len(s.frames)
        s.spans[self.index].frame = s._frame
        self.record = FrameRecord(self.frame_id, self.index)
        s.frames.append(self.record)
        self.counts0 = dict(counts)
        return self

    def __exit__(self, *exc):
        c0 = self.counts0
        self.record.counts = {k: v - c0.get(k, 0) for k, v in counts.items()
                              if v != c0.get(k, 0)}
        self.session._frame = self.outer
        return super().__exit__(*exc)


def span(name: str):
    """A span named ``name`` around the block, recorded while a
    ``torch.profiler`` session is active (else the shared no-op)."""
    if _profiling():
        return _Span(name)
    if _live:
        _close()
    return _NOOP


def frame(frame_id):
    """The root ``frame`` span of one rendered frame (``frame_id``: the
    caller's frame counter): its spans carry its index, and its record
    the counters' deltas over it."""
    if _profiling():
        return _Frame(frame_id)
    if _live:
        _close()
    return _NOOP


def sync(name: str, on, n: int = 1):
    """Where the host waits for the card (a read back, or a copy from
    pageable host memory, which drains the stream first): adds ``n`` (the
    block's waits) to the counter ``name`` and spans the block with it,
    where ``on`` (the tensor read back, or the device copied to) is on a
    CUDA card; else the no-op."""
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type != "cuda":
        return _NOOP
    counts[name] += n
    return span(name)


def in_span(name: str):
    """Decorator: every call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap

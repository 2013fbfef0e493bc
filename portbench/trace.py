"""Reading the card's work from ``torch.profiler``: device events taken
straight from the profiler's results (building its event tree costs tens
of seconds at 10^4-10^5 launches a frame), the union of their intervals,
and host spans timed around the program's calls on the same wall clock,
which name what the host was doing while the device idled."""

from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, List

# host spans of the traced breakdown: (module, attribute) of the program
# functions whose calls the harness times, outermost first; a method is
# "Class.method"
HOST_SPANS = (
    ("owlexabrick_tpu_torch.render.renderer", "Renderer.enable_fast_path"),
    ("owlexabrick_tpu_torch.render.renderer", "Renderer._pick_shearwarp"),
    ("owlexabrick_tpu_torch.render.renderer", "reorient_grids"),
    ("owlexabrick_tpu_torch.render.renderer", "render_slabs_camera"),
    ("owlexabrick_tpu_torch.render.renderer", "warp_image"),
    ("owlexabrick_tpu_torch.render.renderer", "accumulate"),
    ("owlexabrick_tpu_torch.render.renderer", "pack_rgba8"),
    ("owlexabrick_tpu_torch.render.slabs", "compress_pwl"),
    ("owlexabrick_tpu_torch.render.slabs", "render_slabs"),
    ("owlexabrick_tpu_torch.render.slabs", "xresample_mids_levels"),
    ("owlexabrick_tpu_torch.render.slabs", "prepare_chunk"),
    ("owlexabrick_tpu_torch.render.slabs", "combine_activity"),
    ("owlexabrick_tpu_torch.render.slabs", "pack_luts"),
    ("owlexabrick_tpu_torch.render.slabs", "run_chunk"),
)


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    dur_ns: int

    @property
    def is_kernel(self) -> bool:
        """A kernel launch, not a copy or a fill."""
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """One traced stretch: its device events, its frames, its length on
    the host's clock, and what the metrics' taps recorded; ``run``, the
    untraced window before it (``harness.Run``), for a per-layer metric
    read on the host's clock."""

    events: List[DeviceEvent]
    frames: int
    window_s: float
    calls: dict = field(default_factory=dict)
    host_spans: list = field(default_factory=list)
    run: object = None

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device (the union of
        the device events' intervals)."""
        return sum(b - a for a, b in union_intervals(self.events)) / 1e9


def union_intervals(events):
    """Sorted disjoint (start_ns, end_ns) covering the events."""
    spans = sorted((e.start_ns, e.start_ns + e.dur_ns) for e in events)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def _resolve(module: str, attr: str):
    """(owner, name) of ``module``'s ``attr`` ("Class.method" allowed)."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


@contextlib.contextmanager
def wrapped(module: str, attr: str, wrapper_of: Callable):
    """Replace ``module.attr`` by ``wrapper_of(original)`` inside the
    block."""
    owner, name = _resolve(module, attr)
    orig = getattr(owner, name)
    setattr(owner, name, wrapper_of(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def tapped(module: str, attr: str, record: Callable, sink: list):
    """A block in which every call of ``module.attr`` appends
    ``record(args, kwargs, result)`` to ``sink``."""
    def wrapper_of(fn):
        def tap(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append(record(args, kwargs, out))
            return out
        return tap
    return wrapped(module, attr, wrapper_of)


def spanned(module: str, attr: str, sink: list):
    """A block in which every call of ``module.attr`` appends (attr,
    start_ns, end_ns) to ``sink``, on the wall clock the profiler's
    events use (no profiler annotation, so no host activity is traced)."""
    def wrapper_of(fn):
        def span(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.append((attr, t0, time.time_ns()))
        return span
    return wrapped(module, attr, wrapper_of)


def profile(run_frames: Callable[[], int], taps=(), spans=()):
    """Run ``run_frames()`` (which renders frames, each ending
    synchronised, and returns how many) under ``torch.profiler`` with
    device activity only.  ``taps``: (key, module, attr, record) whose
    calls are recorded into ``Trace.calls[key]``; ``spans``: (module,
    attr) whose calls are timed into ``Trace.host_spans``.  Returns the
    Trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    calls = {key: [] for key, *_ in taps}
    host_spans = []
    with contextlib.ExitStack() as stack:
        for key, module, attr, record in taps:
            stack.enter_context(tapped(module, attr, record, calls[key]))
        for module, attr in spans:
            stack.enter_context(spanned(module, attr, host_spans))
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = run_frames()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = [DeviceEvent(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return Trace(events=events, frames=frames, window_s=window_s,
                 calls=calls, host_spans=host_spans)


def device_ops(trace: Trace, top: int = 10):
    """[[name, seconds], ...]: the device operations that took most time
    in the stretch, summed by name."""
    by = {}
    for e in trace.events:
        by[e.name] = by.get(e.name, 0.0) + e.dur_ns / 1e9
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k[:120], v] for k, v in rows]


def idle_gaps(trace: Trace, top: int = 10):
    """[[host span, seconds], ...]: the device's idle time between its
    first and last event, summed by the innermost host span around each
    gap's midpoint ("host: no span" where none)."""
    busy = union_intervals(trace.events)
    # the spans of one thread nest, so a stack of the open ones holds the
    # innermost on top
    spans = sorted(trace.host_spans, key=lambda s: (s[1], -s[2]))
    stack, i, by = [], 0, {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][1] <= mid:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "host: no span"
        by[label] = by.get(label, 0.0) + (b - a) / 1e9
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in rows]

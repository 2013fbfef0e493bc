"""Milliseconds per frame of the window, as ``end_to_end/frame_ms.py``
reads it (its length over the frames completed in it), in the cells
where that is not an end-to-end metric: the host's speed spreads it
between runs by more than half the largest bound allowed (PERF.md,
section 2).  Read from the untraced window of a ``--trace 1`` run."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "portbench_end_to_end_frame_ms_for_frame_ms_zoom",
    pathlib.Path(__file__).parent.parent / "end_to_end" / "frame_ms.py")
_frame_ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_frame_ms)


def read(trace):
    if trace.run is None:
        return None
    return _frame_ms.read(trace.run)

"""A per-layer metric read as another is, under a name of its own.

A quantity whose cells report different end-to-end metrics is split by
name, one name for each end-to-end metric it moves: ``device_idle_pct``
moves ``frame_ms`` where a cell reports it, and ``device_idle_pct.zoom``
moves ``frame_ms_p90`` in the zoom, which does not (PERF.md, section 2).
``metrics/<base>.<suffix>.py`` then holds only

    from portbench.metric_alias import alias

    read = alias(__file__).read

(and ``TAP`` and ``record`` from it too where the base reader taps a
program call): the base reader, ``metrics/<base>.py``, reads the trace,
with this name's tapped calls handed to it under the base's name."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from types import SimpleNamespace


def alias(path: str) -> SimpleNamespace:
    """``read`` (and ``TAP``, ``record`` where the base has them) of the
    metric whose reader file is ``path``, ``<base>.<suffix>.py``."""
    me = pathlib.Path(path)
    name = me.name[:-len(".py")]
    base_name = name.split(".", 1)[0]
    spec = importlib.util.spec_from_file_location(
        f"portbench_metrics_{base_name}_for_{name}".replace(".", "_"),
        me.with_name(f"{base_name}.py"))
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)

    def read(trace):
        if hasattr(base, "TAP"):
            trace = dataclasses.replace(
                trace, calls={base_name: trace.calls.get(name, [])})
        return base.read(trace)

    out = SimpleNamespace(read=read)
    if hasattr(base, "TAP"):
        out.TAP, out.record = base.TAP, base.record
    return out

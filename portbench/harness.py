"""The benchmark's run of one cell, driven by data: ``BENCHMARK.json``
names the cell's configuration, traffic mix and metrics, and each of
them is a file of its own that this module finds by name:

* ``configs/<config>.json``: the scene (made by its generator,
  ``scenes/<pattern>.py``; each field's TF domain), the render size, the
  ``RenderConfig`` fields that differ from the default
  (``render.config``), the plain reference's module under
  ``reference/`` (``render.reference``) and the set-up calls;
* ``traffic/<traffic>.json``: the traffic mix (``traffic.Traffic``);
* ``calls/<call>.py``: each viewer call a configuration or a mix makes,
  applied to the program (``program``) and to the reference's inputs
  (``reference``);
* ``cells/<workload>.json``: what is checked, which frames are traced
  and the limits of the compared numbers;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric (``read(run)`` / ``read(trace)``; a per-layer reader may also
  tap a program function through ``TAP`` and ``record``).

A run: the cells, the program's ``Renderer``, the set-up calls and the
warm-up (set-up); frames back to back for the window, as one user of the
web viewer asks for them (the mix's calls, then ``enable_fast_path()``
and ``render()``); with tracing, a profiled stretch of fixed frames
after the window; then, with the program's state freed, the frames of a
sample drawn from the seed are rendered again by the plain reference and
compared with what the window returned.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from . import compare, trace as tracing
from .scene import scene_cells
from .traffic import Traffic

ROOT = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "owlexabrick_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    params: dict
    end_to_end: dict  # name -> unit
    per_layer: dict  # name -> unit
    chips: int = 1


@dataclass
class Run:
    """What the window did: its length, the frames attempted and
    completed in it, each completed frame's host time and output, the
    device's peak memory and the set-up time."""

    seconds: float
    setup_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    frame_s: list = field(default_factory=list)
    outputs: list = field(default_factory=list)  # (frame, words)
    peak_bytes: int = 0


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: pathlib.Path,
              root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of the benchmark file, with its files."""
    bench = _load_json(bench_path)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    config = _load_json(root / "configs" / f"{cell['config']}.json")
    traffic = _load_json(root / "traffic" / f"{cell['traffic']}.json")
    params = _load_json(root / "cells" / f"{workload}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"] if mine(m)}
    per = {m["name"]: m["unit"] for m in bench["per_layer"]
           if mine(m) and (m["moves"] in e2e)}
    return Cell(name=workload, config=config, traffic=traffic,
                params=params, end_to_end=e2e, per_layer=per,
                chips=int(cell["chips"]))


class Session:
    """The program under test for one cell: the cells and a ``Renderer``
    on ``device`` with the configuration's ``RenderConfig``, set up by the
    configuration's and the traffic mix's set-up calls, then driven frame
    by frame through the viewer's calls.  ``renderer_cls`` and
    ``on_words`` let a test break the timed path underneath."""

    def __init__(self, cell: Cell, seed: int, device="cuda",
                 renderer_cls=None, on_words: Optional[Callable] = None):
        from owlexabrick_tpu_torch.render.renderer import (RenderConfig,
                                                           Renderer)

        self.cell, self.device = cell, device
        cfg = cell.config
        self.n = int(cfg["scene"]["n"])
        self.width, self.height = (int(cfg["render"]["width"]),
                                   int(cfg["render"]["height"]))
        self.build_s = {}
        t0 = time.perf_counter()
        cells, self.cells_how = scene_cells(cfg)
        self.cells = cells
        self.cells_s = time.perf_counter() - t0
        if self.cells_how == "built_and_cached":
            self.build_s["cells"] = self.cells_s
        self.domains = field_domains(cfg["scene"], cells[2])
        self.domain = self.domains[0]
        self.kernels_s = 0.0
        if torch_device_type(device) == "cuda":
            # the kernels' library: built by the first run of a checkout
            # (build/torch_kernels/), loaded by later ones
            from owlexabrick_tpu_torch import kernels

            fresh = not kernels._library_path().exists()
            t0 = time.perf_counter()
            kernels.load()
            self.kernels_s = time.perf_counter() - t0
            if fresh:
                self.build_s["kernels"] = self.kernels_s
        self.reference_module = importlib.import_module(
            f"portbench.reference.{cfg['render'].get('reference', 'render')}")
        self.on_words = on_words
        rc = RenderConfig(**{"num_channels": 1,
                             **cfg["render"].get("config", {})})
        if rc.num_channels != len(self.domains):
            raise ValueError(
                f"{cfg['name']}: render.config num_channels "
                f"{rc.num_channels} for a scene of {len(self.domains)} "
                f"fields (channel c draws field c)")
        cls = renderer_cls or Renderer
        self.r = cls(cells, self.width, self.height, cfg=rc, device=device)
        self.reseed(seed)

    def reseed(self, seed: int):
        """Take the traffic mix's frames for ``seed`` and make the
        configuration's and the mix's set-up calls."""
        self.traffic = Traffic(self.cell.traffic, seed)
        self.setup_calls = (
            self.traffic._calls(self.cell.config.get("setup", []), 0)
            + self.traffic.setup())
        self.apply(self.setup_calls)

    def apply(self, calls):
        """Make the viewer ``calls`` on the program."""
        for name, args in calls:
            _call(name).program(self, args)

    def reference_state(self, f):
        """Traffic frame ``f``'s inputs as the reference takes them: the
        set-up calls and the frame's calls replayed on its state."""
        state = {}
        for name, args in self.setup_calls + f.calls:
            _call(name).reference(self, state, args)
        xf_set = state.pop("xf_channels", ())
        for c in range(len(self.domains)):
            if c not in xf_set:
                raise ValueError(f"no update_xf call set channel {c}'s "
                                 f"transfer function")
        return self.reference_module.FrameInputs(**state)

    def frame(self, k: int):
        """Render traffic frame ``k`` as the web viewer does; returns
        (frame, words)."""
        f = self.traffic.frame(k)
        self.apply(f.calls)
        self.r.enable_fast_path()
        words = self.r.render()
        if self.on_words is not None:
            words = self.on_words(k, words)
        return f, words

    def reference(self, bf16: bool = False, device=None):
        """The plain reference of this scene (the configuration's
        ``render.reference`` module)."""
        return self.reference_module.ReferenceRenderer(
            self.cells, self.width, self.height, device or self.device,
            bf16=bf16, render_config=self.cell.config["render"].get(
                "config", {}))

    def warm_up(self) -> int:
        """Render one frame of each route the traffic's period takes
        (where the traffic asks for it), then its first ``frames``
        frames; returns the index the window starts at."""
        wu = self.cell.traffic.get("warmup", {})
        if wu.get("routes", False):
            router = self.reference(device="cpu")
            seen = set()
            for k in range(self.traffic.period):
                route = router.route(self.reference_state(
                    self.traffic.frame(k)))[0]
                if route not in seen:
                    seen.add(route)
                    self.frame(k)
        n = int(wu.get("frames", 1))
        for k in range(n):
            self.frame(k)
        return n

    def close(self):
        del self.r
        gc.collect()
        _empty_cache(self.device)


def field_domains(scene: dict, scalars) -> list:
    """Each field's value domain: the scene's ``domains`` where it gives
    them, else [0, the field's largest value]."""
    fields = np.atleast_2d(scalars)
    if "domains" not in scene:
        return [[0.0, float(np.max(f))] for f in fields]
    doms = [[float(lo), float(hi)] for lo, hi in scene["domains"]]
    if len(doms) != len(fields):
        raise ValueError(f"scene.domains gives {len(doms)} domains for "
                         f"{len(fields)} fields")
    return doms


_CALLS = {}


def _call(name: str):
    """The module of viewer call ``name`` (``calls/<name>.py``)."""
    if name not in _CALLS:
        _CALLS[name] = _module(ROOT / "calls" / f"{name}.py")
    return _CALLS[name]


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def _empty_cache(device):
    import torch

    if torch_device_type(device) == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_window(sess: Session, start: int, seconds: float) -> Run:
    """Frames back to back from traffic frame ``start`` until ``seconds``
    have passed; a frame that ends after the close is attempted but not
    completed."""
    run = Run(seconds=seconds)
    k = start
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= end:
            break
        f, words = sess.frame(k)
        t1 = time.perf_counter()
        run.attempted += 1
        k += 1
        if t1 <= end:
            run.completed += 1
            run.frame_s.append(t1 - t)
            run.outputs.append((f, words))
    return run


def sample_frames(run: Run, seed: int, count: int, slowest: bool):
    """Indices into ``run.outputs`` to check: ``count`` drawn from the
    seed, and the slowest frame where asked."""
    n = len(run.outputs)
    rng = np.random.default_rng(seed)
    pick = set(rng.choice(n, size=min(count, n), replace=False).tolist())
    if slowest and n:
        pick.add(int(np.argmax(run.frame_s)))
    return sorted(pick)


def check(sess: Session, outputs, picks, device, bf16: bool = False,
          reference=None):
    """Per checked frame, the compared numbers of the program's words
    against the reference's.  Returns ([(frame index, numbers)], the
    reference renderer)."""
    ref = reference or sess.reference(bf16=bf16, device=device)
    rows = []
    for i in picks:
        f, words = outputs[i]
        want = ref.frame_words(sess.reference_state(f))
        rows.append((f.index, compare.frame_numbers(words, want)))
    return rows, ref


def judge(rows, limits: dict):
    """(worst value of each limited number over the checked frames,
    frames over a limit)."""
    worst = {k: max((r[k] for _, r in rows), default=float("inf"))
             for k in limits}
    failed = sum(1 for _, r in rows
                 if any(r[k] > lim for k, lim in limits.items()))
    return worst, failed


def per_layer_metrics(sess: Session, cell: Cell, run: Run):
    """The profiled stretch after the window: the frames at the cell's
    ``trace.phases`` of the traffic mix (the same frames for every seed),
    with device activity, the metrics' taps and the host spans; the
    readers also see the window (``Trace.run``).  Returns (metrics,
    device extras, breakdown)."""
    readers = {name: _module(ROOT / "metrics" / f"{name}.py")
               for name in cell.per_layer}
    taps = [(name, *mod.TAP, mod.record) for name, mod in readers.items()
            if hasattr(mod, "TAP")]
    ks = [sess.traffic.frame_at(p).index
          for p in cell.params["trace"]["phases"]]

    def frames():
        for k in ks:
            sess.frame(k)
        return len(ks)

    tr = tracing.profile(frames, taps=taps, spans=tracing.HOST_SPANS)
    tr.run = run
    metrics = {}
    for name, mod in readers.items():
        v = mod.read(tr)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": cell.per_layer[name]}
    breakdown = {"device_ops": tracing.device_ops(tr),
                 "idle_gaps": tracing.idle_gaps(tr)}
    return metrics, dict(busy_s=tr.busy_s(), window_s=tr.window_s), breakdown


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start,
             device="cuda", renderer_cls=None, on_words=None,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)):
    """One run of ``cell``; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
    tracing, ``checks`` last)."""
    import torch

    cuda = torch_device_type(device) == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_session = time.perf_counter()
    sess = Session(cell, seed, device, renderer_cls=renderer_cls,
                   on_words=on_words)
    t_warm = time.perf_counter()
    start = sess.warm_up()
    if cuda:
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    log(f"portbench: {cell.name} seed {seed}: {len(sess.cells[1]):,} cells "
        f"of {len(sess.domains)} field(s) {sess.cells_how}, "
        f"set-up {setup_s:.3f} s: start and imports "
        f"{t_session - t_start:.3f}, cells {sess.cells_s:.3f}, kernels "
        f"{sess.kernels_s:.3f}, Renderer "
        f"{t_warm - t_session - sess.cells_s - sess.kernels_s:.3f}, "
        f"warm-up frames {t_window - t_warm:.3f}")

    run = run_window(sess, start, seconds)
    run.setup_s = setup_s
    run.peak_bytes = (torch.cuda.max_memory_allocated() if cuda else 0)
    log(f"portbench: window {seconds} s: {run.completed} frames completed "
        f"of {run.attempted}; frame ms "
        + " ".join(f"{1e3 * t:.1f}" for t in run.frame_s))

    extras, breakdown, metrics = {}, None, {}
    if trace:
        metrics, extras, breakdown = per_layer_metrics(sess, cell, run)
        log(f"portbench: traced {extras}; idle by host span "
            f"{breakdown['idle_gaps']}")
    else:
        for name, unit in cell.end_to_end.items():
            v = _module(ROOT / "end_to_end" / f"{name}.py").read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    sess.close()

    chk = cell.params["check"]
    picks = sample_frames(run, seed, int(chk["frames"]),
                          bool(chk.get("slowest", False)))
    outputs = run.outputs
    run.outputs = []
    t_check = time.perf_counter()
    rows, ref = check(sess, outputs, picks, device)
    del ref, outputs
    log(f"portbench: reference of {len(rows)} frames "
        f"{time.perf_counter() - t_check:.1f} s")
    limits = {k: float(v) for k, v in cell.params["limits"].items()}
    worst, failed = judge(rows, limits)
    for idx, r in rows:
        log(f"portbench: checked frame {idx}: " + ", ".join(
            f"{k} {v}" for k, v in r.items()))
    correct = bool(rows) and failed == 0
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(run.peak_bytes)}
    dev.update(extras)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # what this run built because the checkout had not yet: the kernels'
    # library, the configuration's cells file (part of setup_s)
    result["first_run_build_s"] = sess.build_s
    result["checks"] = checks
    return result

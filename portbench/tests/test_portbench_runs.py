"""The harness's run of each cell at a size a CPU test can hold, with the
cell's own files and limits: a sound run is correct; runs whose timed
path is broken underneath, and the control in the program's place, are
not.  A card test runs the same tiny cells on the card with tracing."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT, tiny_cell

CELLS = ["exajet256.zoom", "exajet1024.tf_drag"]


def _run(cell, seed=2 ** 31 + 11, seconds=2.0, **kw):
    from portbench import harness

    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device=kw.pop("device", "cpu"),
                            log=lambda *a: None, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(tiny_cell(workload))
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(tiny_cell(workload).params["limits"])
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert {"setup_s", "peak_mem_mb"} <= set(res["metrics"])
    cell = tiny_cell(workload)
    assert ("frame_ms" in res["metrics"]) == ("frame_ms" in cell.end_to_end)
    assert res["attempted"] >= 1


def _stale(cls):
    """A Renderer whose frame returns the state it had: the previous
    frame's image."""
    class Stale(cls):
        last = None

        def render(self):
            out = super().render()
            prev, self.last = self.last, out
            return out if prev is None else prev
    return Stale


def _half(cls):
    """A Renderer that leaves half of the pixels (the bottom rows) out of
    its frame."""
    class Half(cls):
        def render(self):
            out = super().render().copy()
            out[: out.shape[0] // 2] = 0xFF000000
            return out
    return Half


def _altered(k, words):
    """An answer altered where it is produced: every colour channel of
    every frame raised by 3 levels."""
    c = words.astype(np.int64)
    ch = [np.clip(((c >> s) & 0xFF) + 3, 0, 255) for s in (0, 8, 16)]
    return (ch[0] | (ch[1] << 8) | (ch[2] << 16) | 0xFF000000).astype(
        np.uint32)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_timed_path_is_not_correct(workload, fault):
    from owlexabrick_tpu_torch.render.renderer import Renderer

    kw = dict(stale=dict(renderer_cls=_stale(Renderer)),
              half=dict(renderer_cls=_half(Renderer)),
              altered=dict(on_words=_altered))[fault]
    res = _run(tiny_cell(workload), **kw)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference computed in bfloat16, in the program's place, on
    three seeds: over a limit on each."""
    from portbench import calibrate, harness

    cell = tiny_cell(workload)
    limits = cell.params["limits"]
    recs = []
    calibrate.readings(cell, [1], [1, 2, 3], 4, "cpu", recs.append)
    prog = [r for r in recs if r["side"] == "program"]
    ctrl = [r for r in recs if r["side"] == "control"]
    assert all(c[k] == 0.0 for r in prog for c in r["checked"] for k in limits)
    assert len(ctrl) == 3
    for r in ctrl:
        rows = [(c["frame"], c) for c in r["checked"]]
        worst, failed = harness.judge(rows, limits)
        assert failed >= 1, worst


def test_no_jax_after_harness_and_reference():
    """In a process of its own: after importing the harness, the
    reference, the generators and the metric readers and running a tiny
    cell, no loaded module's top-level name is jax, jaxlib, flax or
    owlexabrick_tpu."""
    code = """
import sys, time
sys.path.insert(0, "portbench/tests")
from conftest import tiny_cell
from portbench import harness, calibrate, scene, traffic, trace, yardstick
from portbench.reference import render, slabs, sweep, shearwarp, grids, xf
for p in (harness.ROOT / "metrics").glob("*.py"):
    harness._module(p)
harness.run_cell(tiny_cell("exajet1024.tf_drag"), 1, 0.5, False,
                 time.perf_counter(), device="cpu", log=lambda *a: None)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, text=True, capture_output=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_card_with_trace(cuda, workload):
    from portbench import harness

    cell = tiny_cell(workload, n=64, width=192, height=108)
    res = harness.run_cell(cell, 3, 2.0, True, time.perf_counter(),
                           device="cuda", log=lambda *a: None)
    assert res["correct"], json.dumps(res["checks"])
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a quantity split by the end-to-end metric it moves keeps its base
    # name before the first dot (device_idle_pct.zoom)
    bases = {name.split(".", 1)[0] for name in res["metrics"]}
    assert {"device_idle_pct", "launches_per_frame",
            "k1_roofline_pct"} <= bases
    assert set(res["metrics"]) <= set(cell.per_layer)
    for name, m in res["metrics"].items():
        if name.split(".", 1)[0] in ("k1_roofline_pct", "k6_roofline_pct"):
            assert 0 < m["value"] <= 105

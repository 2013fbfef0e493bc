"""The frozen yardstick against the port it was copied from, today: the
exajet generator, the Jet colours handed to both sides, and the plain
reference's frames bit for bit against the port's Renderer on the CPU
(where the port runs the same plain-torch functions)."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell


@pytest.mark.parametrize("wings", [1, 2])
def test_generator_equals_port(wings):
    from owlexabrick_tpu_torch.bench_scene import exajet_pattern_cells

    from portbench.scene import exajet_pattern_cells as frozen

    want = exajet_pattern_cells(64, wings=wings)
    got = frozen(64, wings=wings)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_generator_pool_equals_serial(monkeypatch):
    from portbench import scene

    serial = scene.exajet_pattern_cells(64, wings=2)
    # the pool from this size on, in two processes
    monkeypatch.setattr(scene, "POOL_MIN_N", 64)
    monkeypatch.setattr(scene, "default_workers", lambda: 2)
    pooled = scene.exajet_pattern_cells(64, wings=2)
    for a, b in zip(pooled, serial):
        np.testing.assert_array_equal(a, b)


def test_cells_cache_round_trip(tmp_path):
    from portbench.scene import scene_cells

    cfg = {"name": "tiny", "scene": {"pattern": "exajet", "n": 32,
                                     "wings": 2, "threshold": 0.004,
                                     "max_level": 3, "cache": True}}
    built, how = scene_cells(cfg, cache_dir=tmp_path)
    assert how == "built_and_cached"
    loaded, how = scene_cells(cfg, cache_dir=tmp_path)
    assert how == "loaded"
    for a, b in zip(built, loaded):
        np.testing.assert_array_equal(a, b)
    assert [p.name for p in tmp_path.iterdir()] == ["cells_tiny.npz"]


def test_jet_input_equals_viewer_colormap():
    import json

    from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

    from portbench.harness import ROOT

    with open(ROOT / "inputs" / "jet.json") as f:
        frozen = np.asarray(json.load(f)["colors"], np.float32)
    np.testing.assert_array_equal(frozen, colormap_colors("Jet", 128))


def test_jitter_equals_port():
    from owlexabrick_tpu_torch.render.renderer import default_jitter

    from portbench.reference.render import default_jitter as frozen

    for k in (0, 1, 7, 1000):
        assert frozen(k) == default_jitter(k)


def orbit_cell():
    """The orbit mix (no cell runs it yet) on the tiny exajet256 scene,
    started on a quarter turn, so that it meets a diagonal, where the
    Renderer takes the reorientation preview."""
    import json

    from conftest import ROOT

    cell = tiny_cell("exajet256.zoom")
    cell.traffic = json.loads(
        (ROOT / "portbench" / "traffic" / "orbit.json").read_text())
    cam = cell.traffic["calls"][0]["eye"]["orbit"]
    cam["azimuth_deg"] = {"linear": [0.0, 3.0]}
    return cell


@pytest.mark.parametrize("workload", ["exajet256.zoom", "exajet1024.tf_drag",
                                      "orbit"])
def test_reference_equals_port_on_cpu(workload):
    """Frames of the traffic, bit for bit: the first of each route a
    period takes (for the orbit: shear-warp on two axes and the
    reorientation preview) and a few more."""
    from portbench import harness

    cell = orbit_cell() if workload == "orbit" else tiny_cell(workload)
    sess = harness.Session(cell, seed=5, device="cpu")
    ref = sess.reference()
    firsts = {}
    for k in range(sess.traffic.period):
        route = ref.route(sess.reference_state(sess.traffic.frame(k)))[0]
        firsts.setdefault(route, k)
    for k in sorted(firsts.values()) + [1, 2, 13]:
        f, words = sess.frame(k)
        np.testing.assert_array_equal(
            words, ref.frame_words(sess.reference_state(f)))
    kinds = {kind for kind, _ in firsts}
    want = dict(orbit={"shearwarp", "reorient"}, zoom={"shearwarp"})
    assert kinds == want.get(workload.split(".")[-1], {"aligned"})
    if workload == "orbit":
        assert len(firsts) == 3


def test_control_rounds_to_bfloat16():
    from portbench.reference.grids import rnd

    t = torch.tensor([1.0 + 2.0 ** -10, 3.0])
    assert rnd(t, False) is t
    assert rnd(t, True).tolist() == [1.0, 3.0]

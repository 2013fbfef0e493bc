"""PyTorch port, the offline viewer CLI's ``--fast`` branches against the
JAX package's CLI on the same scene directory and command line, under
the golden gate: aligned (``render_slabs_camera``), tilted (shear-warp),
``--bands 2`` (``render_slabs_banded``), the clip box (the Renderer's
fast path) and ``--multi-field``.  The JAX CLI's fast path passes its
TPU-only ``SlabConfig.extent_z``, which the port does not have: the gate
on these images shows the image does not move without it."""

import pathlib

import pytest

from test_torch_cli import assert_gate, make_scene_dir, run_both
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene_dir(tmp_path_factory.mktemp("cli_fast"))


FAST = ["--fast", "--size", "40", "30", "--dt", "0.7", "--frames", "2"]


@pytest.mark.parametrize("case", ["aligned", "tilted", "bands2", "clip",
                                  "multi_field"])
def test_cli_fast(scene_dir, tmp_path, case):
    """The bare --fast path renders one field (a one-field config: the
    JAX CLI's bare fast path fails on a second field it does not
    render) and --multi-field both fields of the two-field config."""
    eye = {"tilted": ["14", "9", "20"]}.get(case, ["5", "3", "30"])
    exa = "scene.exa" if case == "multi_field" else "one.exa"
    args = [str(scene_dir / exa), *FAST, "--camera", *eye, "5", "3", "3",
            "0", "1", "0", "--fov", "40"]
    args += {"bands2": ["--bands", "2"],
             "clip": ["--clip-box", "2", "0", "0", "10", "6", "4"],
             "multi_field": ["--multi-field", "--range", "0", "7"]
             }.get(case, [])
    a, b, lines = run_both(tmp_path, args)
    want = {"tilted": "#viewer: fast path via shear-warp (exact)",
            "bands2": "#viewer: banded fast path (2 z-bands)",
            "clip": "#viewer: fast path via Renderer (surfaces/clip/"
                    "shading composited)"}.get(case)
    assert want is None or want in lines, lines
    assert any("FPS" in l for l in lines)
    assert b.shape == (30, 40, 4 if case == "clip" else 3)
    assert_gate(b, a, case)


def test_cli_fast_second_field_not_rendered(scene_dir, tmp_path):
    """The port's bare --fast path on the two-field config without
    --multi-field renders channel 0 alone: the same PNG as the one-field
    config (where the JAX CLI raises an IndexError)."""
    from owlexabrick_tpu_torch.viewer.offline import main

    outs = []
    for exa in ("one.exa", "scene.exa"):
        outs.append(str(tmp_path / f"{exa}.png"))
        assert main([str(scene_dir / exa), *FAST, "--frames", "1",
                     "--device", "cpu", "-o", outs[-1]]) == 0
    a, b = (pathlib.Path(o).read_bytes() for o in outs)
    assert a == b

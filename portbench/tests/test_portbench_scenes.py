"""Scene generators found by name, multi-field scenes, per-field domains
and per-channel transfer-function calls: the exajet pattern through the
lookup, a two-field scene (``tests/scenes/exajet_twofield.py``) through
the cache and a CPU ``Session``, and both cells' reference inputs as the
one-field harness made them."""

import dataclasses
import pathlib

import numpy as np
import pytest

from conftest import tiny_cell

CELLS = ["exajet256.zoom", "exajet1024.tf_drag"]
TEST_SCENES = pathlib.Path(__file__).resolve().parent / "scenes"
SCENE = {"n": 32, "wings": 1, "threshold": 0.004, "max_level": 3,
         "cache": False}


@pytest.fixture
def test_scenes(monkeypatch):
    from portbench import scene

    monkeypatch.setattr(scene, "SCENES", TEST_SCENES)


@pytest.mark.parametrize("wings", [1, 2])
def test_exajet_lookup_equals_frozen_generator(wings):
    from portbench.scene import exajet_pattern_cells, scene_cells

    want = exajet_pattern_cells(64, wings=wings)
    cfg = {"name": "x", "scene": dict(SCENE, pattern="exajet", n=64,
                                      wings=wings)}
    got, how = scene_cells(cfg)
    assert how == "built"
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_unknown_pattern_names_its_file():
    from portbench.scene import scene_cells

    with pytest.raises(ValueError, match=r"scenes/no_such_scene\.py"):
        scene_cells({"name": "x", "scene": dict(SCENE,
                                                pattern="no_such_scene")})


def test_fields_beyond_the_port_cap_are_refused():
    from owlexabrick_tpu_torch.core.constants import MAX_CHANNELS

    from portbench.scene import check_cells

    lower = np.zeros((4, 3), np.int32)
    level = np.zeros(4, np.int32)
    check_cells((lower, level, np.zeros((MAX_CHANNELS, 4), np.float32)))
    for bad in (np.zeros((MAX_CHANNELS + 1, 4), np.float32),
                np.zeros((2, 5), np.float32), np.zeros(4, np.float64)):
        with pytest.raises(ValueError):
            check_cells((lower, level, bad))


def test_two_fields_round_trip_through_the_cache(tmp_path, test_scenes):
    from portbench.scene import scene_cells

    cfg = {"name": "twofield", "scene": dict(SCENE,
                                             pattern="exajet_twofield",
                                             cache=True)}
    built, how = scene_cells(cfg, cache_dir=tmp_path)
    assert how == "built_and_cached" and built[2].shape[0] == 2
    loaded, how = scene_cells(cfg, cache_dir=tmp_path)
    assert how == "loaded"
    for a, b in zip(built, loaded):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "cells_twofield.npz") as z:
        assert z["scalars"].shape == (2, built[0].shape[0])


def test_field_domains():
    from portbench.harness import field_domains

    two = np.asarray([[0.0, 2.0], [1.0, 5.0]], np.float32)
    assert field_domains({}, two) == [[0.0, 2.0], [0.0, 5.0]]
    assert field_domains({}, two[0]) == [[0.0, 2.0]]
    given = {"domains": [[-1, 1], [0.5, 4]]}
    assert field_domains(given, two) == [[-1.0, 1.0], [0.5, 4.0]]
    with pytest.raises(ValueError):
        field_domains({"domains": [[0, 1]]}, two)


def _two_field_cell(setup_channels=(0, 1)):
    """A tiny two-field cell that no configuration names: the eye at the
    aligned pose in frame 0 and at the tilted one in frame 1, channel 1's
    ramp moving every frame."""
    from portbench.harness import Cell

    setup = [{"call": "update_dt", "dt": 1.0}]
    setup += [{"call": "update_xf", "channel": c, "colormap": "jet",
               "lower": 0.1 * c, "opacity_scale": 0.7}
              for c in setup_channels]
    config = {"name": "twofield",
              "scene": dict(SCENE, pattern="exajet_twofield"),
              "render": {"width": 96, "height": 54,
                         "config": {"num_channels": 2}},
              "setup": setup}
    traffic = {"period": 2, "calls": [
        {"call": "update_camera",
         "eye": {"lerp": [[0.5, 0.5, 2.2], [0.9, 0.8, 2.2]],
                 "t": {"linear": [0.0, 1.0]}},
         "at": [0.5, 0.5, 0.5], "up": [0.0, 1.0, 0.0], "fovy_deg": 45.0},
        {"call": "update_xf", "channel": 1,
         "lower": {"linear": [0.2, 0.1]}}]}
    return Cell(name="twofield", config=config, traffic=traffic, params={},
                end_to_end={}, per_layer={})


def test_two_field_session_renders_aligned_and_tilted(test_scenes):
    from portbench import harness
    from portbench.calls import update_xf
    from portbench.reference.render import ReferenceRenderer

    sess = harness.Session(_two_field_cell(), 0, "cpu")
    fields = sess.cells[2]
    assert fields.shape[0] == 2
    assert sess.domains == [[0.0, float(fields[0].max())],
                            [0.0, float(fields[1].max())]]
    assert sess.domains[1] != sess.domains[0]
    assert sess.domain == sess.domains[0]
    router = ReferenceRenderer(sess.cells, 96, 54, "cpu")
    routes, frames = [], []
    for k in range(2):
        f, words = sess.frame(k)
        fs = sess.r.fs
        np.testing.assert_array_equal(
            np.asarray(fs.xf_domain), np.asarray(sess.domains, np.float32))
        np.testing.assert_array_equal(
            np.asarray(fs.xf_lut)[1, :, 3],
            update_xf.opacities(0.2 + 0.1 * k))
        fi = sess.reference_state(f)
        assert fi.xf_lut.shape == (2, 128, 4)
        np.testing.assert_array_equal(fi.xf_lut, np.asarray(fs.xf_lut))
        np.testing.assert_array_equal(fi.xf_domain, np.asarray(fs.xf_domain))
        routes.append(router.route(fi)[0][0])
        assert words.shape == (54, 96) and np.any(words & 0xFFFFFF)
        frames.append(words)
    assert routes == ["aligned", "shearwarp"]
    # channel 1 is drawn: shutting its ramp changes the tilted frame
    sess.apply([("update_xf", {"channel": 1, "lower": 0.999})])
    sess.r.enable_fast_path()
    assert not np.array_equal(sess.r.render(), frames[1])


def test_channel_beyond_the_fields_raises(test_scenes):
    from portbench import harness
    from portbench.calls import update_xf

    sess = harness.Session(_two_field_cell(), 0, "cpu")
    args = {"channel": 2, "lower": 0.1}
    with pytest.raises(ValueError, match="channel 2"):
        sess.apply([("update_xf", args)])
    with pytest.raises(ValueError, match="channel 2"):
        update_xf.reference(sess, {}, args)


def test_unset_channel_is_named(test_scenes):
    from portbench import harness

    sess = harness.Session(_two_field_cell(setup_channels=(0,)), 0, "cpu")
    # frame 0 without its channel-1 edit: the camera call alone
    f = dataclasses.replace(sess.traffic.frame(0),
                            calls=sess.traffic.frame(0).calls[:1])
    with pytest.raises(ValueError, match="channel 1"):
        sess.reference_state(f)


def test_render_reference_refuses_two_channels(test_scenes):
    from portbench import harness
    from portbench.reference.render import ReferenceRenderer

    sess = harness.Session(_two_field_cell(), 0, "cpu")
    with pytest.raises(ValueError, match="num_channels"):
        sess.reference(device="cpu")
    with pytest.raises(ValueError, match="num_channels"):
        ReferenceRenderer(sess.cells, 96, 54, "cpu",
                          render_config={"num_channels": 2})


def _one_field_update_xf(sess, state, args):
    """The one-field harness's reference side of ``update_xf``: a (1, 128,
    4) table and a (1, 2) domain [0, the scene's largest value] made
    anew by each call."""
    from portbench.calls.update_xf import colors, opacities

    if int(args.get("channel", 0)) != 0:
        raise ValueError("the reference holds one channel's transfer "
                         "function")
    rgb = (colors(args["colormap"]) if "colormap" in args
           else state["xf_lut"][0, :, :3])
    lut = np.concatenate([rgb, opacities(args["lower"])[:, None]], 1)[None]
    domain = [0.0, float(np.max(sess.cells[2]))]
    state.update(xf_lut=lut.astype(np.float32),
                 xf_domain=np.asarray([domain], np.float32),
                 xf_opacity_scale=np.float32(args.get(
                     "opacity_scale", state.get("xf_opacity_scale"))))


@pytest.mark.parametrize("workload", CELLS)
def test_reference_state_as_the_one_field_harness_made_it(workload):
    """Over one period of each cell's mix, the reference's inputs equal,
    byte for byte, what the one-field harness's calls made."""
    from portbench import harness

    sess = harness.Session(tiny_cell(workload), 2 ** 31 + 11, "cpu")
    assert sess.domain == [0.0, float(np.max(sess.cells[2]))]
    for k in range(sess.traffic.period):
        f = sess.traffic.frame(k)
        want = {}
        for name, args in sess.setup_calls + f.calls:
            call = (_one_field_update_xf if name == "update_xf"
                    else harness._call(name).reference)
            call(sess, want, args)
        got = vars(sess.reference_state(f))
        assert set(got) == set(want) | {"frame_id"}
        for key, v in want.items():
            a, b = np.asarray(got[key]), np.asarray(v)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key

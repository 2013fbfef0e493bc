"""PyTorch port, the Renderer's exact frame (no ``enable_fast_path()``) on
the CPU: the eight exact-path goldens of tests/test_golden_images.py
(32^3 bench scene, 96x64, 2 frames, ao_exact 6) rendered through
``Renderer(scene)`` with the scene built by the port's own pipeline
(native core), under the reference's golden gate (every pixel within
1/255, >= 99% bit-exact); a cells-built Renderer's lazy scene is
``scene_from_cells``'s and renders the same frames; contour planes are
set like the JAX Renderer sets them.  The same frames against the JAX
Renderer's, and the fast path's contour and ao_exact frames:
tests/test_torch_renderer_exact_fast.py."""

import dataclasses

import numpy as np
import pytest
import torch

from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.pipeline import scene_from_cells
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.frame import make_frame_state
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _check, _quad_surface
from test_torch_renderer_surfaces import _helix
from torch_threads import one_torch_thread  # noqa: F401

ISO = dict(iso_enabled=np.asarray([True, False]),
           iso_value=np.asarray([0.55, 0.0], np.float32),
           iso_channel=np.zeros(2, np.int32))
_NORMALS = np.zeros((3, 3), np.float32)
_NORMALS[0] = [0.0, 0.0, 1.0]
CONTOUR = dict(contour_enabled=np.asarray([True, False, False]),
               contour_normal=_NORMALS,
               contour_offset=np.asarray([0.65, 0.5, 0.5], np.float32),
               contour_channel=np.zeros(3, np.int32))
CLIP = dict(clip_enabled=np.bool_(True),
            clip_lo=np.asarray([N * 0.25, 0.0, 0.0], np.float32),
            clip_hi=np.asarray([N, N, N * 0.8], np.float32))
AO = dict(ao_enabled=np.bool_(True), ao_length=np.float32(N * 0.5))

# name: (RenderConfig fields, surfaces, frame-state patch, frames)
GOLDENS = {
    "wavefront": ({}, None, {}, 2),
    "iso": (dict(iso_surfaces=True), None, ISO, 2),
    "contour": ({}, None, CONTOUR, 2),
    "clipbox": ({}, None, CLIP, 2),
    "mesh_volume": ({}, "quad", {}, 2),
    "tracer_segments": ({}, "helix", dict(tracer_timestep=np.int32(25)), 2),
    "ao_exact": (dict(iso_surfaces=True, ao_samples=2), None,
                 dict(ISO, **AO), 6),
}


@pytest.fixture(scope="module")
def cells():
    return volume_to_cells(synthetic_volume(N), 0.004, 3)


@pytest.fixture(scope="module")
def scene(cells):
    lower, level, scal = cells
    return scene_from_cells(lower, level, [scal], device="cpu")[0]


def _frame_state(n_ch=1, domains=((0.0, 1.05),), opacity=0.7, **patch):
    cam = Camera.look_at([N / 2, N / 2, N * 2.1], [N / 2] * 3, [0, 1, 0],
                         45.0, W, H)
    fs = make_frame_state(cam, n_ch, [list(d) for d in domains], dt=1.0,
                          opacity_scale=opacity)
    return dataclasses.replace(fs, **patch)


def _surfaces(name):
    ref = {"quad": _quad_surface, "helix": _helix}[name]()
    return interop.surface_data_from_reference(ref, "cpu")


@pytest.mark.parametrize("name", list(GOLDENS))
def test_exact_golden(scene, name):
    cfg_kw, surf, patch, frames = GOLDENS[name]
    r = Renderer(scene, W, H, cfg=RenderConfig(num_channels=1, **cfg_kw),
                 frame_state=_frame_state(**patch), device="cpu",
                 surfaces=None if surf is None else _surfaces(surf))
    img = r.image_uint8(r.render_frames(frames))
    assert r._fast is None
    assert (img[..., :3] > 16).any(), "blank render"
    _check(np.ascontiguousarray(img), name)


def test_exact_golden_multichannel(cells):
    """Two channels classified per sample in the reference's channel
    order, value ranges over both (num_range_channels=2)."""
    lower, level, scal = cells
    s2, *_ = scene_from_cells(lower, level, [scal, 1.05 - scal],
                              num_range_channels=2, device="cpu")
    r = Renderer(s2, W, H, cfg=RenderConfig(num_channels=2),
                 frame_state=_frame_state(2, ((0.0, 1.05), (0.0, 4.0)),
                                          0.5), device="cpu")
    img = r.image_uint8(r.render_frames(2))
    _check(np.ascontiguousarray(img), "multichannel")


def test_cells_renderer_builds_its_scene_lazily(cells, scene):
    """A cells-built Renderer has no scene until a feature needs one: the
    exact frame builds ``scene_from_cells``'s (equal tensors), and its
    frames are the scene-built Renderer's bit for bit."""
    lower, level, scal = cells
    fs = _frame_state(**CONTOUR)
    a = Renderer((lower, level, scal[None]), W, H, frame_state=fs,
                 device="cpu")
    assert a._scene is None
    got = a.render()
    assert a._scene is not None
    for k, v in scene.host_arrays().items():
        assert np.array_equal(a.scene.host_arrays()[k], v), k
    b = Renderer(scene, W, H, frame_state=fs, device="cpu")
    assert np.array_equal(got, b.render())
    assert torch.equal(a.accum, b.accum)
    # the fast path of a cells-built Renderer keeps its cell grids
    c = Renderer((lower, level, scal[None]), W, H,
                 frame_state=_frame_state(), device="cpu")
    assert c.enable_fast_path() and c._scene is None
    c.render()
    assert c._scene is None


def test_update_contour_planes(scene):
    """Normals are normalized, fields set like the JAX Renderer's
    update_contour_planes, and accumulation restarts."""
    r = Renderer(scene, W, H, frame_state=_frame_state(), device="cpu")
    r.render()
    r.update_contour_planes([[0, 0, 2.0], [1, 1, 0], [0, 1, 0]],
                            [0.65, 0.3, 0.5], [0, 0, 0],
                            [True, True, False])
    assert int(r.fs.frame_id) == 0
    np.testing.assert_allclose(np.linalg.norm(r.fs.contour_normal, axis=1),
                               1.0, rtol=1e-6)
    assert r.fs.contour_normal.dtype == np.float32
    assert list(r.fs.contour_enabled) == [True, True, False]
    img = r.image_uint8(r.render())
    assert (img[..., :3] > 16).any()

"""PyTorch port, the Renderer's state updates and its AO gate against the
JAX Renderer's fast path: ``update_dt`` and ``resize`` give the JAX
Renderer's next frames, and every AO setting that leaves the JAX fast
path's image without AO renders here too, under the golden gate (every
pixel within 1/255, >= 99% bit-exact), on the 32^3 golden scene at
64x48 with the default (JAX) jitter.  What needs the exact scene
(contour planes, ``ao_exact``) renders the JAX Renderer's image too: the
cells-built port Renderer builds its scene at first need."""

import dataclasses

import numpy as np
import pytest

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu_torch import bench_scene, interop
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells
from torch_threads import one_torch_thread  # noqa: F401

N, W, H = 32, 64, 48
ISO = 0.55


@pytest.fixture(scope="module")
def cells():
    lower, level, scal = volume_to_cells(bench_scene.synthetic_volume(N),
                                         0.004, 3)
    return lower, level, scal


def _set_ao(r, enabled):
    r.fs = dataclasses.replace(r.fs, ao_enabled=np.bool_(enabled))


def _pair(cells, ao_enabled=False, iso=False, **cfg_kw):
    """The JAX Renderer and the port's on the same scene, camera, frame
    state and config, both on the slab fast path."""
    lower, level, scal = cells
    scene, *_ = scene_from_cells(lower, level, [scal])
    cam = RefCamera.look_at([N / 2, N / 2, N * 2.1], [N / 2] * 3, [0, 1, 0],
                            45.0, W, H)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7)
    ref = RefRenderer(scene, W, H, frame_state=fs,
                      cfg=RefRenderConfig(num_channels=1, iso_surfaces=iso,
                                          **cfg_kw))
    port = Renderer((lower, level, scal[None]), W, H,
                    cfg=RenderConfig(num_channels=1, iso_surfaces=iso,
                                     **cfg_kw),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu")
    for r in (ref, port):
        if iso:
            r.update_iso_values([ISO, 0.0], [0, 0], [True, False])
        _set_ao(r, ao_enabled)
        assert r.enable_fast_path()
    return ref, port


def _gate(ref, port, frames=1):
    want = ref.image_uint8(ref.render_frames(frames))
    got = port.image_uint8(port.render_frames(frames))
    assert got.shape == want.shape
    assert (want[..., :3] > 16).any()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99, (
        d.max(), (d == 0).all(-1).mean())


@pytest.mark.parametrize("case", [
    "dvr_samples_enabled",      # AO asked for, no iso surface to shade
    "iso_enabled_no_samples",   # ao_enabled, but no AO samples
    "iso_samples_unshaded",     # iso without gradient shading: no AO
    "iso_samples_disabled",     # the AO pass runs, fs.ao_enabled = False
])
def test_ao_settings_without_shading_match_jax(cells, case):
    """Every AO setting in which the JAX fast path's image has no AO term
    renders as the JAX Renderer renders it (two frames)."""
    kw = dict(
        dvr_samples_enabled=dict(ao_enabled=True, ao_samples=4),
        iso_enabled_no_samples=dict(ao_enabled=True, iso=True),
        iso_samples_unshaded=dict(ao_enabled=True, iso=True, ao_samples=4,
                                  gradient_shading_iso=False),
        iso_samples_disabled=dict(ao_enabled=False, iso=True, ao_samples=4),
    )[case]
    _gate(*_pair(cells, **kw), frames=2)


@pytest.mark.parametrize("feature", ["contour_plane", "ao_exact"])
def test_exact_scene_features_raise(cells, feature):
    """An enabled contour plane and ``ao_exact`` on a frame with AO sample
    the exact scene: they no longer raise.  With either on, the fast
    path enables and renders the JAX Renderer's frame under the golden
    gate; the port's cells-built Renderer builds its scene for it."""
    ref, port = _pair(cells, ao_enabled=True, iso=True, ao_samples=2)
    assert port._scene is None
    for r in (ref, port):
        if feature == "contour_plane":
            r.fs = dataclasses.replace(r.fs, contour_enabled=np.asarray(
                [True, False, False]))
        else:
            r.ao_exact = True
        assert r.enable_fast_path()
    _gate(ref, port)
    assert port._scene is not None


def test_update_dt_matches_jax(cells):
    """A frame, then ``update_dt(0.5)`` (accumulation reset, the slab
    count kept), then the fast path enabled again (the slab count from
    the new dt): each frame equals the JAX Renderer's under the gate."""
    ref, port = _pair(cells)
    _gate(ref, port)
    for r in (ref, port):
        r.update_dt(0.5)
        assert int(r.fs.frame_id) == 0 and float(r.fs.dt) == 0.5
    assert float(port.accum.abs().max()) == 0.0
    _gate(ref, port)
    for r in (ref, port):
        assert r.enable_fast_path()
    assert port._fast[1].nslabs == ref._fast[1].nslabs
    _gate(ref, port)


def test_resize_matches_jax(cells):
    """A frame at 64x48, ``resize(48, 40)``, two frames: the JAX
    Renderer's images at the new size; the port's camera products cached
    for the old size are dropped."""
    ref, port = _pair(cells)
    _gate(ref, port)
    port.reset_accumulation()
    port.render()  # frame 0 again at its pose: the products are cached
    assert port._cam_cache is not None
    for r in (ref, port):
        r.resize(48, 40)
        assert (r.width, r.height, int(r.fs.frame_id)) == (48, 40, 0)
    assert port._cam_cache is None and port.accum.shape == (48 * 40, 4)
    _gate(ref, port, frames=2)

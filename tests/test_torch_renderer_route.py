"""PyTorch port, the Renderer's exact route against the JAX Renderer's
(renderer.py:934-960) on the CPU: each package's route is recorded (the
port's ``exact_route``; the JAX functions wrapped in place) and the
frames compared under the golden gate (2 frames, 96x64, the 32^3 golden
scene and camera): the default config takes the compacted packed march,
``wavefront_compaction=False`` ``render_step_packed``, gradient shading
the classic ``trace_dvr``, and a scene whose ``build_pack`` raises
``ValueError`` the classic march too; an ALLOW_EMPTY_CELLS scene takes
the packed route in both packages (24x24 on the poisoned EX2)."""

import pytest

import owlexabrick_tpu.render.renderer as ref_renderer
import owlexabrick_tpu.render.wavefront as ref_wavefront
from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render import wavefront
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_empty_cells import _poisoned_scene
from test_golden_images import H, N, W, _cam
from test_torch_renderer_surfaces import _gate
from torch_threads import one_torch_thread  # noqa: F401

# config fields, stub build_pack, the JAX and the port route
CASES = {
    "default": ({}, False, "packed_compacted"),
    "no_compaction": (dict(wavefront_compaction=False), False, "packed"),
    "gradient_shading": (dict(gradient_shading_dvr=True), False, "classic"),
    "pack_refused": ({}, True, "classic"),
}


@pytest.fixture(scope="module")
def scenes():
    lower, level, scal = volume_to_cells(synthetic_volume(N), 0.004, 3)
    ref, *_ = ref_scene_from_cells(lower, level, [scal])
    return ref, interop.scene_from_reference(ref, "cpu")


def _spy_jax_routes(monkeypatch):
    """Record which exact route the JAX Renderer's ``render`` takes,
    wrapping its three entry points where ``render`` looks them up."""
    taken = []

    def spy(module, name, route):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            taken.append(route)
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(ref_wavefront, "trace_dvr_packed_compacted", "packed_compacted")
    spy(ref_renderer, "render_step_packed", "packed")
    spy(ref_renderer, "render_step", "classic")
    return taken


def _refuse(*_a, **_k):
    raise ValueError("node/region ids exceed exact float32 range")


def _pair(ref_scene, port_scene, fs, w, h, **cfg_kw):
    ref = RefRenderer(ref_scene, w, h, frame_state=fs,
                      cfg=RefRenderConfig(num_channels=1, **cfg_kw))
    port = Renderer(port_scene, w, h,
                    cfg=RenderConfig(num_channels=1, **cfg_kw),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu")
    return ref, port


@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_jax(scenes, monkeypatch, case):
    cfg_kw, refuse, route = CASES[case]
    if refuse:
        monkeypatch.setattr(ref_wavefront, "build_pack", _refuse)
        monkeypatch.setattr(wavefront, "build_pack", _refuse)
    taken = _spy_jax_routes(monkeypatch)
    fs = make_frame_state(_cam(), 1, [[0.0, 1.05]], dt=1.0,
                          opacity_scale=0.7)
    ref, port = _pair(*scenes, fs, W, H, **cfg_kw)
    _gate(ref, port, frames=2)
    assert taken == [route] * 2
    assert port.exact_route == route
    assert (port._pack is False) == refuse


def test_empty_cells_take_the_packed_route(amr_fixture, monkeypatch):
    """ALLOW_EMPTY_CELLS does not change the route: both packages march
    a poisoned scene through the packed sampler (which reads the grids'
    cells as they are), and their frames agree."""
    ref_scene, *_ = _poisoned_scene(amr_fixture)
    taken = _spy_jax_routes(monkeypatch)
    cam = Camera.look_at([12.0, 10.0, 14.0], [4.0, 2.0, 2.0], [0, 1, 0],
                         50.0, 24, 24)
    fs = make_frame_state(cam, 1, [[0.0, 7.0]], dt=0.7)
    ref, port = _pair(ref_scene, interop.scene_from_reference(ref_scene,
                                                              "cpu"),
                      fs, 24, 24, allow_empty_cells=True)
    _gate(ref, port, frames=2)
    assert taken == ["packed_compacted"] * 2
    assert port.exact_route == "packed_compacted"

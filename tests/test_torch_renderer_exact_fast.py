"""PyTorch port, frames that need the exact scene against the JAX
Renderer's on the CPU (32^3 golden scene, 96x64, the goldens' camera, TF
and recipes): the exact frame with a contour plane and the clip box, the
fast path's contour plane (aligned, and through shear-warp: K1 under the
plane's surface stop, K6, and K2a/K2b on the card), and the fast path's
``ao_exact`` (hemisphere rays against the exact iso march over the iso
sweep's hits), each under the golden gate (every pixel within 1/255,
>= 99% bit-exact)."""

import dataclasses

import pytest

from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _cam
from test_torch_renderer_exact import AO, CLIP, CONTOUR, ISO
from test_torch_renderer_surfaces import _gate
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    lower, level, scal = volume_to_cells(synthetic_volume(N), 0.004, 3)
    ref, *_ = ref_scene_from_cells(lower, level, [scal])
    return ref, interop.scene_from_reference(ref, "cpu")


def _pair(scenes, *, fast, tilted=False, fs_patch=None, ao_exact=False,
          **cfg_kw):
    """The JAX Renderer and the port's on one scene, camera, frame state
    and config."""
    ref_scene, port_scene = scenes
    fs = make_frame_state(_cam(tilted), 1, [[0.0, 1.05]], dt=1.0,
                          opacity_scale=0.7)
    fs = dataclasses.replace(fs, **(fs_patch or {}))
    ref = RefRenderer(ref_scene, W, H, frame_state=fs,
                      cfg=RefRenderConfig(num_channels=1, **cfg_kw))
    port = Renderer(port_scene, W, H, cfg=RenderConfig(num_channels=1,
                                                       **cfg_kw),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu")
    ref.ao_exact = port.ao_exact = ao_exact
    if fast:
        for r in (ref, port):
            assert r.enable_fast_path()
        assert (port._fast[2] == "shearwarp") == tilted
    return ref, port


def test_exact_frame_matches_jax(scenes):
    """render_step's frame: a contour plane and the clip box, 1 frame."""
    _gate(*_pair(scenes, fast=False, fs_patch=dict(CONTOUR, **CLIP)),
          frames=1)


@pytest.mark.parametrize("tilted", [False, True], ids=["aligned", "tilted"])
def test_fast_contour_matches_jax(scenes, tilted):
    """A contour plane on the slab fast path: traced on the sweep's rays,
    colored from the exact scene, its depth the volume's stop."""
    _gate(*_pair(scenes, fast=True, tilted=tilted, fs_patch=CONTOUR))


def test_fast_ao_exact_matches_jax(scenes):
    """AO over the iso sweep's shaded hits with ``ao_exact``: two
    hemisphere rays per pixel and frame against the exact iso march."""
    _gate(*_pair(scenes, fast=True, fs_patch=dict(ISO, **AO), ao_exact=True,
                 iso_surfaces=True, ao_samples=2))

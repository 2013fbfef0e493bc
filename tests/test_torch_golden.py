"""PyTorch port, Renderer: the fast_aligned, fast_stride and
fast_shearwarp goldens of the JAX package (32^3 bench scene, 96x64, 2
frames) rendered through the port's Renderer and held to the reference's golden gate
(tests/test_golden_images.py::_check).  The per-frame jitter is the
Renderer's default, the JAX Renderer's jax.random draws in numpy."""

import numpy as np
import pytest

from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.frame import make_frame_state
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _check
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cells():
    lower, level, scal = volume_to_cells(synthetic_volume(N), 0.004, 3)
    return lower, level, scal[None]


def _renderer(cells, stride, device="cpu", tilted=False):
    # tests/test_golden_images.py::_cam
    eye = [N * 0.9, N * 0.8, N * 2.1] if tilted else [N / 2, N / 2, N * 2.1]
    cam = Camera.look_at(eye, [N / 2, N / 2, N / 2], [0, 1, 0], 45.0, W, H)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7)
    r = Renderer(cells, W, H,
                 cfg=RenderConfig(num_channels=1, adaptive_stride=stride),
                 frame_state=fs, device=device)
    assert r.enable_fast_path()
    return r


@pytest.mark.parametrize("name,stride,tilted", [
    ("fast_aligned", False, False), ("fast_stride", True, False),
    ("fast_shearwarp", False, True)])
def test_port_renderer_golden(cells, name, stride, tilted):
    r = _renderer(cells, stride, tilted=tilted)
    assert (r._fast[2] == "shearwarp") == tilted
    img = r.image_uint8(r.render_frames(2))
    assert (img[..., :3] > 16).any(), "blank render"
    _check(np.ascontiguousarray(img), name)


@pytest.mark.parametrize("tilted", [False, True], ids=["aligned", "tilted"])
def test_renderer_static_pose_uses_camera_cache(cells, tilted):
    """A TF edit at a fixed pose resets accumulation and renders frame 0
    again through the camera-product cache — the same image (under
    shear-warp the pose key holds the frame's lattice)."""
    r = _renderer(cells, True, tilted=tilted)
    a = r.render()
    assert r._cam_cache is None
    r.update_xf(0, r.fs.xf_lut[0, :, :3], r.fs.xf_lut[0, :, 3],
                r.fs.xf_domain[0], float(r.fs.xf_opacity_scale))
    b = r.render()
    assert r._cam_cache is not None and "key" in r._cam_cache
    assert np.array_equal(a, b)


def test_renderer_unported_features_raise(cells):
    """Nothing the fast path offers raises any more: a contour plane
    (colored from the exact scene, which a cells-built Renderer builds
    at first need) and ``ao_exact`` (hemisphere rays against the exact
    iso march) render, and so do AO on gradient-shaded iso hits (the
    lattice estimator), AO where the JAX fast path draws no AO term,
    the clip box and DVR gradient shading (the einsum lane), and iso
    surfaces (the iso sweep, then K1 with its surface stop)."""
    import dataclasses

    r = _renderer(cells, False)
    r.fs = dataclasses.replace(r.fs, contour_enabled=np.asarray(
        [True, False, False]))
    assert (r.image_uint8(r.render())[..., :3] > 16).any()
    assert r._scene is not None
    r = Renderer(cells, W, H, cfg=RenderConfig(iso_surfaces=True,
                                               ao_samples=4),
                 frame_state=dataclasses.replace(
                     _renderer(cells, False).fs, ao_enabled=np.bool_(True)),
                 device="cpu")
    r.update_iso_values([0.55, 0.0], [0, 0], [True, False])
    assert r.enable_fast_path()
    lattice = r.image_uint8(r.render())
    assert (lattice[..., :3] > 16).any()
    r.ao_exact = True
    r.reset_accumulation()
    exact = r.image_uint8(r.render())
    assert (exact[..., :3] > 16).any() and not np.array_equal(exact, lattice)
    r = _renderer(cells, False)
    r.fs = dataclasses.replace(r.fs, ao_enabled=np.bool_(True))
    assert (r.image_uint8(r.render())[..., :3] > 16).any()
    r = Renderer(cells, W, H, cfg=RenderConfig(iso_surfaces=True),
                 frame_state=_renderer(cells, False).fs, device="cpu")
    r.update_iso_values([0.55, 0.0], [0, 0], [True, False])
    assert r.enable_fast_path()
    assert (r.image_uint8(r.render())[..., :3] > 16).any()
    r = _renderer(cells, False)
    r.set_clip_box(True, [N * 0.25, 0.0, 0.0], [N, N, N * 0.8])
    img = r.image_uint8(r.render())
    assert (img[..., :3] > 16).any()
    fs = dataclasses.replace(r.fs, clip_enabled=np.bool_(False))
    r = Renderer(cells, W, H, cfg=RenderConfig(gradient_shading_dvr=True),
                 frame_state=fs, device="cpu")
    assert r.enable_fast_path() and r._fast[1].gradient_shading_dvr
    assert (r.image_uint8(r.render())[..., :3] > 16).any()
    # a tilted camera is no longer refused: it takes shear-warp
    tilted = Camera.look_at([N * 0.9, N * 0.8, N * 2.1],
                            [N / 2, N / 2, N / 2], [0, 1, 0], 45.0, W, H)
    r = _renderer(cells, False)
    r.update_camera(tilted)
    assert r.enable_fast_path() and r._fast[2] == "shearwarp"


def test_default_jitter_is_seeded():
    from owlexabrick_tpu_torch.render.renderer import default_jitter

    a = default_jitter(3)
    assert a == default_jitter(3) and a != default_jitter(4)
    assert all(-0.5 <= v < 0.5 for v in a)

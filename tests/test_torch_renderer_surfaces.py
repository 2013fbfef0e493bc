"""PyTorch port, the Renderer's surfaces against the JAX Renderer's fast
path: meshes, streamline segments, a tilted camera with a mesh and mesh
AO without iso surfaces (the surface pass's dense geometric AO), on the
32^3 golden scene at 96x64 over 2 frames, under the golden gate (every
pixel within 1/255, >= 99% bit-exact).  The lattice AO's frames:
tests/test_torch_renderer_ao.py."""

import dataclasses

import numpy as np
import pytest

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu.render.surfaces import SurfaceData as RefSurfaceData
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _cam, _quad_surface

ISO = dict(iso_enabled=np.asarray([True, False]),
           iso_value=np.asarray([0.55, 0.0], np.float32),
           iso_channel=np.zeros(2, np.int32))
AO = dict(ao_enabled=np.bool_(True), ao_length=np.float32(N * 0.5))


@pytest.fixture(scope="module")
def cells():
    return volume_to_cells(synthetic_volume(N), 0.004, 3)


def _helix():
    """tests/test_golden_images.py::test_golden_tracer_segments' helix."""
    t = np.linspace(0.0, 4.0 * np.pi, 33)
    pts = np.stack([
        N * 0.5 + N * 0.55 * np.cos(t),
        N * 0.5 + N * 0.55 * np.sin(t),
        N * 0.8 + t * (N * 0.2 / (4.0 * np.pi)),
    ], axis=1).astype(np.float32)
    z = np.zeros((0, 3), np.float32)
    return RefSurfaceData(
        tri_v0=z, tri_e1=z, tri_e2=z, tri_n=z, seg_a=pts[:-1],
        seg_b=pts[1:], seg_t=np.arange(1, 33, dtype=np.int32),
        seg_radius=np.float32(1.2))


def _quad_and_wall():
    """The golden quad and a slanted wall through it, so the geometric AO
    has an occluder in view."""
    q = _quad_surface()
    v0 = np.concatenate([q.tri_v0, [[2.0, N * 0.3, N * 0.3]]]).astype(
        np.float32)
    e1 = np.concatenate([q.tri_e1, [[N - 4.0, 0.0, 0.0]]]).astype(np.float32)
    e2 = np.concatenate([q.tri_e2, [[0.0, N * 0.2, N * 0.5]]]).astype(
        np.float32)
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dataclasses.replace(q, tri_v0=v0, tri_e1=e1, tri_e2=e2,
                               tri_n=n.astype(np.float32))


def _pair(cells, surf, *, tilted=False, fs_patch=None, **cfg_kw):
    """The JAX Renderer and the port's on the same scene, camera, frame
    state, surfaces and config, both on the slab fast path."""
    lower, level, scal = cells
    scene, *_ = scene_from_cells(lower, level, [scal])
    fs = make_frame_state(_cam(tilted), 1, [[0.0, 1.05]], dt=1.0,
                          opacity_scale=0.7)
    if fs_patch:
        fs = dataclasses.replace(fs, **fs_patch)
    ref = RefRenderer(scene, W, H, frame_state=fs, surfaces=surf,
                      cfg=RefRenderConfig(num_channels=1, **cfg_kw))
    port = Renderer((lower, level, scal[None]), W, H,
                    cfg=RenderConfig(num_channels=1, **cfg_kw),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu",
                    surfaces=(None if surf is None else
                              interop.surface_data_from_reference(surf,
                                                                  "cpu")))
    for r in (ref, port):
        assert r.enable_fast_path()
    assert (port._fast[2] == "shearwarp") == tilted
    return ref, port


def _gate(ref, port, frames=2):
    want = ref.image_uint8(ref.render_frames(frames))
    got = port.image_uint8(port.render_frames(frames))
    assert got.shape == want.shape
    assert (want[..., :3] > 16).any()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99, (
        d.max(), (d == 0).all(-1).mean())
    return got


def test_mesh_volume_matches_jax(cells):
    """The mesh_volume golden's recipe: the quad stops the volume."""
    _gate(*_pair(cells, _quad_surface()))


def test_tracer_segments_matches_jax(cells):
    """The tracer_segments golden's recipe: rounded cones, the last 8
    segments hidden by the timestep cull."""
    _gate(*_pair(cells, _helix(),
                 fs_patch=dict(tracer_timestep=np.int32(25))))


def test_tilted_mesh_matches_jax(cells):
    """The quad through shear-warp: traced on the lattice rays, then
    warped with the volume."""
    _gate(*_pair(cells, _quad_surface(), tilted=True))


def test_mesh_geometric_ao_matches_jax(cells):
    """Mesh AO without iso surfaces: the surface pass's dense geometric
    AO (two hemisphere rays per pixel and frame)."""
    _gate(*_pair(cells, _quad_and_wall(), fs_patch=AO, ao_samples=2))

"""PyTorch port, the einsum lane (clip box, DVR gradient shading,
multi-channel under the clip box): K3 and K4's plain versions against
the JAX package's Pallas kernels in interpret mode; the lane's frames
against the JAX package's ``render_slabs_camera`` for aligned, swapped
and shear-warp lattice cameras; the Renderer's clip box and shading
against the JAX Renderer (golden gate) and against the JAX wavefront
renderer (the fast path's feature budgets); and the card-by-default
entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import pallas_xf as RX
from owlexabrick_tpu.render import shearwarp as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import bench_scene, interop
from owlexabrick_tpu_torch.render import classify as PC
from owlexabrick_tpu_torch.render import shearwarp as PS
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.renderer import (
    RenderConfig, Renderer, clip_interval)
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells
from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

from conftest import EX2, EX3, EX4
from test_torch_slabs import _gate


# ---------------------------------------------------------------------------
# K3 / K4: plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _lut(kind, rng):
    """(128, 4) alpha-prescaled LUTs: a random one spanning the domain,
    a smooth colormap with a ramp, and opacity-1 steps."""
    if kind == "random":
        return rng.uniform(0.0, 1.0, (128, 4)).astype(np.float32)
    if kind == "smooth":
        ramp = np.linspace(0.0, 0.8, 128, dtype=np.float32)
        return np.concatenate([colormap_colors("Jet", 128), ramp[:, None]],
                              1).astype(np.float32)
    lut = _lut("smooth", rng)
    lut[:, 3] = np.where((np.arange(128) // 16) % 2 == 1, 1.0, 0.0)
    return lut


def _fields(s, h, w, seed):
    """Seeded sw, swv, sec, live: invalid pixels (sw = 0), values beyond
    the domain on both sides, a dead slab, grazing rays (large sec)."""
    rng = np.random.default_rng(seed)
    sw = rng.uniform(0.0, 2.0, (s, h, w)).astype(np.float32)
    sw[rng.uniform(size=sw.shape) < 0.15] = 0.0
    value = rng.uniform(-0.4, 1.4, (s, h, w)).astype(np.float32)
    swv = (value * np.where(sw > 0, sw, 1.0)).astype(np.float32)
    sec = rng.uniform(1.0, 6.0, (h, w)).astype(np.float32)
    sec[0, :7] = 900.0
    live = np.ones(s, bool)
    live[1] = False
    return sw, swv, sec, live


@pytest.mark.parametrize("lut_kind,tol", [
    ("random", 3e-5), ("smooth", 1e-5), ("steps", 3e-5)])
@pytest.mark.parametrize("shape", [(5, 21, 200), (3, 13, 512)],
                         ids=["W200", "W512"])
def test_k3_k4_plain_match_pallas(lut_kind, tol, shape):
    """classify_field_reference / composite_chunk_reference against
    pallas_xf.classify_field / composite_chunk (interpret mode), every
    output value.  H is no multiple of 8 and W = 200 no multiple of 128,
    so the TPU kernel's remainder tiles show; the tolerance is the TPU
    kernel's knot walk, which sums up to 127 LUT differences."""
    rng = np.random.default_rng(7)
    lut = _lut(lut_kind, rng)
    sw, swv, sec, live = _fields(*shape, seed=3)
    dom = np.asarray([0.1, 0.9], np.float32)
    dz = np.float32(0.75)
    ref = RX.classify_field(jnp.asarray(sw), jnp.asarray(swv),
                            jnp.asarray(sec), jnp.asarray(lut), dom, dz,
                            interpret=True)
    t = [torch.from_numpy(a) for a in (sw, swv, sec, lut)]
    got = PC.classify_field(t[0], t[1], t[2], t[3], dom, dz)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) <= tol
    assert float(got[3].max()) > 0.5
    assert float((got[3] == 0).float().mean()) > 0.1
    rgb_r, t_r = RX.composite_chunk(jnp.asarray(sw), jnp.asarray(swv),
                                    jnp.asarray(sec), jnp.asarray(live),
                                    jnp.asarray(lut), dom, dz,
                                    interpret=True)
    rgb_g, t_g = PC.composite_chunk_reference(
        t[0], t[1], t[2], torch.from_numpy(live), t[3], dom, dz)
    assert float(np.abs(rgb_g.numpy() - np.asarray(rgb_r)).max()) <= tol
    assert float(np.abs(t_g.numpy() - np.asarray(t_r)).max()) <= tol
    assert float(t_g.min()) < 0.5


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: no fallback."""
    sw, swv, sec, live = (torch.from_numpy(a) for a in _fields(2, 3, 4, 0))
    lut = torch.zeros(128, 4)
    with pytest.raises(ValueError):
        PC.classify_field_cuda(sw, swv, sec, lut, (0.0, 1.0), 1.0)
    with pytest.raises(ValueError):
        PC.composite_mids_cuda([swv[None].expand(2, -1, -1, -1)],
                               [torch.zeros(2, 3, 4)], torch.ones(2), None,
                               None, sec, lut, (0.0, 1.0), 1.0)


# ---------------------------------------------------------------------------
# the lane: render_slabs_camera vs the JAX package's
# ---------------------------------------------------------------------------

W = H = 24
# the box (voxel = world here) cuts every fixture's far half in x and z
BOX = ([2.5, 0.0, 0.0], [8.0, 8.0, 5.5])


def _grids(text, channels):
    lower, level, scal = parse_grids_text(text)
    fields = [scal, 7.0 - scal][:channels]
    scene, bricks, *_ = scene_from_cells(lower, level, fields)
    g = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
    return (jax.tree.map(jnp.asarray, g),
            interop.level_grids_from_reference(g, device="cpu"))


@pytest.fixture(scope="module")
def scenes():
    return {(name, c): _grids(text, c)
            for name, text in (("EX2", EX2), ("EX3", EX3), ("EX4", EX4))
            for c in (1, 2)}


def _lane_case(camera, channels, grad):
    eye, up, w, h = {
        "aligned": ((4.0, 4.0, 26.0), (0, 1, 0), W, H),
        # pixel x along grid y: rendered transposed
        "swapped": ((4.0, 4.0, 26.0), (1, 0, 0), 20, H),
        "tilted": ((14.0, 11.0, 17.0), (0, 1, 0), W, H),
    }[camera]
    cam = Camera.look_at(list(eye), [4.0, 4.0, 4.0], list(up), 30.0, w, h)
    fs = make_frame_state(
        RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                  dir_dv=cam.dir_dv), channels,
        [[0.0, 7.0], [0.0, 9.0]][:channels], dt=1.0, opacity_scale=0.8,
        gradient_shading_dvr=grad)
    return cam, fs, w, h


@pytest.mark.parametrize("name,channels,grad,clip,camera", [
    ("EX3", 1, False, True, "aligned"),    # K3
    ("EX4", 1, False, True, "swapped"),    # K3, transposed interval
    ("EX2", 1, False, True, "tilted"),     # K3 on a lattice camera
    ("EX3", 2, False, True, "aligned"),    # K4 + channel merge
    ("EX4", 2, False, True, "tilted"),
    ("EX2", 1, True, False, "aligned"),    # K4 + shading
    ("EX3", 1, True, False, "swapped"),
    ("EX3", 2, True, False, "tilted"),
    ("EX4", 2, True, True, "aligned"),     # everything at once
])
def test_einsum_lane_matches_reference(scenes, name, channels, grad, clip,
                                       camera):
    """The port's einsum lane (fp32 2-tap lerps) against the JAX
    package's (dense tent einsums) on the same grids, frame state and
    clip interval, under the sweep's gate (1e-4 on 99.5% of pixels, 2e-2
    on all)."""
    g_ref, g_port = scenes[(name, channels)]
    cam, fs_r, w, h = _lane_case(camera, channels, grad)
    fs = interop.frame_state_from_reference(fs_r)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    kw = dict(num_channels=channels, nslabs=16, chunk=4,
              gradient_shading_dvr=grad)
    rcfg = R.SlabConfig(dot_precision="highest", extent_z=extent, **kw)
    pcfg = P.SlabConfig(**kw)
    lat = sw_p = None
    if camera == "tilted":
        iw, ih = PS.inter_dims(w, h)
        sw_r = RS.setup_shearwarp(
            RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                      dir_dv=cam.dir_dv), 2, w, h, iw, ih)
        sw_p = PS.setup_shearwarp(cam, 2, w, h, iw, ih)
        lat = sw_p.lattice(0.2, -0.3)
        assert np.array_equal(lat[0], sw_r.lattice(0.2, -0.3)[0])
        cam_s, cam_r, w, h = sw_p.camera, sw_r.camera, sw_p.width, sw_p.height
    else:
        cam_s = cam
        cam_r = RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                          dir_dv=cam.dir_dv)
    interval = {}
    if clip:
        t0, t1 = clip_interval(2, cam_s, lat, w, h, np.eye(3, 4), cam_s.pos,
                               *BOX, device="cpu")
        assert bool(torch.isinf(t0).any()) and bool(torch.isfinite(t0).any())
        interval = dict(t_start=t0, t_stop=t1)
    got = P.render_slabs_camera(g_port, fs, pcfg, cam_s, w, h,
                                lattice=lat, **interval)
    ref = np.asarray(R.render_slabs_camera(
        g_ref, fs_r, rcfg, cam_r, w, h, lattice=lat,
        **{k: jnp.asarray(v.numpy()) for k, v in interval.items()}))
    assert ref[:, 3].max() > 0.3
    _gate(got.numpy(), ref, 1e-4)
    if clip:
        # the clip removes something the unclipped frame shows
        full = P.render_slabs_camera(g_port, fs, pcfg, cam_s, w, h,
                                     lattice=lat)
        assert float((full[:, 3] - got[:, 3]).max()) > 0.05


def test_einsum_lane_takes_no_camera_cache(scenes):
    """The einsum lane has no product cache: a cache dict stays empty
    and the frame is the uncached one."""
    g_ref, g_port = scenes[("EX3", 1)]
    cam, fs_r, w, h = _lane_case("aligned", 1, True)
    fs = interop.frame_state_from_reference(fs_r)
    cfg = P.SlabConfig(nslabs=16, chunk=4, gradient_shading_dvr=True)
    cache = {}
    a = P.render_slabs_camera(g_port, fs, cfg, cam, w, h, camera_cache=cache)
    assert "key" not in cache and "products" not in cache
    assert torch.equal(a, P.render_slabs_camera(g_port, fs, cfg, cam, w, h))
    assert P.effective_chunk(g_port, dataclasses.replace(cfg, chunk=40),
                             h, w, None) == 40
    with pytest.raises(ValueError):
        P.render_slabs(g_port, fs, cfg, *P.permute_camera(cam, 2), w, h,
                       return_products=True)


# ---------------------------------------------------------------------------
# the Renderer: clip box and shading vs the JAX Renderer and wavefront
# ---------------------------------------------------------------------------

GN, GW, GH = 32, 96, 64
# tests/test_golden_images.py::test_golden_clipbox's box
CLIPBOX = ([GN * 0.25, 0.0, 0.0], [GN, GN, GN * 0.8])


def _jax_jitter(frame_id):
    """The JAX Renderer's per-frame jitter (renderer.py:453-458)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0x51AB), frame_id)
    return (float(jax.random.uniform(jax.random.fold_in(key, 0), ())) - 0.5,
            float(jax.random.uniform(jax.random.fold_in(key, 1), ())) - 0.5)


@pytest.fixture(scope="module")
def golden_cells():
    lower, level, scal = volume_to_cells(bench_scene.synthetic_volume(GN),
                                         0.004, 3)
    return lower, level, scal


def _both_renderers(cells, case, fast=True):
    lower, level, scal = cells
    channels = 2 if case == "two_channel_clip" else 1
    fields = [scal, 1.05 - scal][:channels]
    scene, *_ = scene_from_cells(lower, level, fields,
                                 num_range_channels=channels)
    eye = ([GN * 0.9, GN * 0.8, GN * 2.1] if case == "tilted_clip"
           else [GN / 2, GN / 2, GN * 2.1])
    cam = RefCamera.look_at(eye, [GN / 2] * 3, [0, 1, 0], 45.0, GW, GH)
    grad = case == "gradient"
    fs = make_frame_state(cam, channels, [[0.0, 1.05], [0.0, 4.0]][:channels],
                          dt=1.0, opacity_scale=0.7,
                          gradient_shading_dvr=grad)
    ref = RefRenderer(scene, GW, GH, frame_state=fs, cfg=RefRenderConfig(
        num_channels=channels, gradient_shading_dvr=grad))
    port = Renderer((lower, level, np.stack(fields)), GW, GH,
                    cfg=RenderConfig(num_channels=channels,
                                     gradient_shading_dvr=grad,
                                     adaptive_stride=False),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu", jitter=_jax_jitter)
    for r in (ref, port):
        if case != "gradient":
            r.set_clip_box(True, *CLIPBOX)
        assert r.enable_fast_path()
    assert (port._fast[2] == "shearwarp") == (case == "tilted_clip")
    return ref, port


@pytest.mark.parametrize("case", ["aligned_clip", "tilted_clip", "gradient",
                                  "two_channel_clip"])
def test_renderer_matches_jax_renderer(golden_cells, case):
    """The port's Renderer against the JAX Renderer on the 32^3 golden
    scene, 2 frames, the clipbox golden's box (aligned and through
    shear-warp), gradient shading, and two channels under the box:
    every pixel within 1/255, >= 99% bit-exact."""
    ref, port = _both_renderers(golden_cells, case)
    want = ref.image_uint8(ref.render_frames(2))
    got = port.image_uint8(port.render_frames(2))
    assert (want[..., :3] > 16).any()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99, (
        d.max(), (d == 0).all(-1).mean())


@pytest.mark.parametrize("camera", ["aligned", "tilted"])
def test_clip_interval_equals_reference(golden_cells, camera):
    """The port's clip interval (rays built in torch) against the JAX
    Renderer's (``_sweep_rays_world`` in host numpy, then ``ray_box``):
    rays, norms and the (t_start, t_stop) interval bit for bit, for a
    screen camera and a jittered shear-warp lattice."""
    import types

    from owlexabrick_tpu.render.dvr import ray_box as ref_ray_box
    from owlexabrick_tpu_torch.render.renderer import sweep_rays_world

    ref, _ = _both_renderers(golden_cells, "aligned_clip")
    eye = [GN * 0.9, GN * 0.8, GN * 2.1] if camera == "tilted" else (
        [GN / 2, GN / 2, GN * 2.1])
    cam = Camera.look_at(eye, [GN / 2] * 3, [0, 1, 0], 45.0, GW, GH)
    lat, w, h = None, GW, GH
    if camera == "tilted":
        sw = PS.setup_shearwarp(cam, 2, GW, GH, *PS.inter_dims(GW, GH))
        lat, cam, w, h = sw.lattice(0.31, -0.17), sw.camera, sw.width, sw.height
    o_r, d_r, n_r = ref._sweep_rays_world(
        types.SimpleNamespace(axis=2),
        RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                  dir_dv=cam.dir_dv), lat, w, h)
    d_p, n_p = sweep_rays_world(2, cam, lat, w, h, np.eye(3, 4), "cpu")
    assert np.array_equal(d_p.numpy(), d_r) and np.array_equal(n_p.numpy(), n_r)
    hit, c0, c1 = ref_ray_box(jnp.asarray(o_r), jnp.asarray(d_r),
                              jnp.asarray(CLIPBOX[0], jnp.float32),
                              jnp.asarray(CLIPBOX[1], jnp.float32),
                              jnp.zeros(w * h, jnp.float32),
                              jnp.full(w * h, 2e10, jnp.float32))
    want = (np.asarray(jnp.where(hit, c0, jnp.inf) / n_r),
            np.asarray(jnp.where(hit, c1, 0.0) / n_r))
    got = clip_interval(2, cam, lat, w, h, np.eye(3, 4), ref.fs.cam_pos,
                        *CLIPBOX, device="cpu")
    for g, r in zip(got, want):
        assert np.array_equal(g.numpy(), r)
    assert bool(np.isinf(want[0]).any()) and bool(np.isfinite(want[0]).any())


def test_renderer_default_clip_box_is_world_bounds(golden_cells):
    """Built without a frame state, both Renderers clip to the scene's
    world bounds, so set_clip_box(True) alone gives the same image."""
    lower, level, scal = golden_cells
    scene, *_ = scene_from_cells(lower, level, [scal])
    ref = RefRenderer(scene, GW, GH)
    port = Renderer((lower, level, scal[None]), GW, GH, device="cpu",
                    jitter=_jax_jitter)
    assert np.array_equal(port.fs.clip_lo, np.asarray(ref.fs.clip_lo,
                                                      np.float32))
    assert np.array_equal(port.fs.clip_hi, np.asarray(ref.fs.clip_hi,
                                                      np.float32))
    for r in (ref, port):
        r.update_xf(0, r.fs.xf_lut[0, :, :3], r.fs.xf_lut[0, :, 3],
                    [0.0, 1.05], 0.7)
        r.set_clip_box(True)
        assert bool(r.fs.clip_enabled) and int(r.fs.frame_id) == 0
        assert r.enable_fast_path()
    want = ref.image_uint8(ref.render())
    got = port.image_uint8(port.render())
    assert (want[..., :3] > 16).any()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99
    # the static pose renders frame 0 again (no product cache to reuse)
    port.update_xf(0, port.fs.xf_lut[0, :, :3], port.fs.xf_lut[0, :, 3],
                   [0.0, 1.05], 0.7)
    assert np.array_equal(port.image_uint8(port.render()), got)
    assert "key" not in (port._cam_cache or {})


@pytest.mark.parametrize("feature,frac8,frac40", [
    ("clip", 0.94, 0.99), ("gradient", 0.91, 0.995)])
def test_fast_frames_within_wavefront_budgets(feature, frac8, frac40):
    """The port's fast frames against the JAX wavefront renderer under
    tests/test_fastpath_features.py::_compare's budgets (64^2, EX2,
    4 accumulated frames): the fidelity the JAX fast path is held to."""
    size = 64
    lower, level, scal = parse_grids_text(EX2)
    scene, *_ = scene_from_cells(lower, level, [scal])
    cam = RefCamera.look_at([4.0, 4.0, 30.0], [4.0, 4.0, 4.0], [0, 1, 0],
                            30.0, size, size)
    grad = feature == "gradient"
    fs = make_frame_state(cam, 1, [[0.0, 7.0]], dt=0.1, opacity_scale=0.5,
                          gradient_shading_dvr=grad)
    if not grad:
        fs = dataclasses.replace(
            fs, clip_enabled=np.bool_(True),
            clip_lo=np.asarray([1.5, 1.5, 1.5], np.float32),
            clip_hi=np.asarray([6.5, 6.5, 6.5], np.float32))
    exact = RefRenderer(scene, size, size, frame_state=fs,
                        cfg=RefRenderConfig(num_channels=1,
                                            gradient_shading_dvr=grad))
    port = Renderer((lower, level, scal[None]), size, size,
                    cfg=RenderConfig(gradient_shading_dvr=grad),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu", jitter=_jax_jitter)
    assert port.enable_fast_path()
    a = port.render_frames(4).view(np.uint8).reshape(size, size, 4)
    b = exact.render_frames(4).view(np.uint8).reshape(size, size, 4)
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert (d < 8).mean() >= frac8, (d < 8).mean()
    assert (d < 40).mean() >= frac40, (d < 40).mean()
    if not grad:
        assert a[0, 0, :3].max() < 8 and a[size // 2, size // 2, :3].max() > 8


# ---------------------------------------------------------------------------
# entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    """Renderer, level_grids_from_cells, build_level_grids and
    slab_scene_grids default to device='cuda': where there is no card
    they raise rather than fall back, and device='cpu' works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lower, level, scal = parse_grids_text(EX3)
    scene, bricks, *_ = scene_from_cells(lower, level, [scal])
    for call in (lambda **kw: Renderer((lower, level, scal[None]), 8, 8,
                                       **kw),
                 lambda **kw: P.level_grids_from_cells(lower, level,
                                                       scal[None], **kw),
                 lambda **kw: P.build_level_grids(bricks, scene.scalars,
                                                  **kw),
                 lambda **kw: bench_scene.slab_scene_grids("blobs", 8,
                                                           **kw)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
        call(device="cpu")

"""PyTorch port, the iso-surface path: K5's plain version against the
JAX package's Pallas ``xf_classify`` (interpret mode); K1's surface stop
against ``pallas_sweep.sweep_chunk`` and, end to end, ``render_slabs``
with a per-pixel ``t_stop`` against the JAX package's (aligned, swapped,
lattice, cached); ``render_slabs_iso`` against the JAX package's (rgba,
depth, normals, cos); and the Renderer with iso surfaces against the
JAX Renderer's fast path under the golden gate.  Inputs are made from a
seed with numpy and fed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import pallas_sweep as RSW
from owlexabrick_tpu.render import pallas_xf as RX
from owlexabrick_tpu.render import shearwarp as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import classify as PC
from owlexabrick_tpu_torch.render import shearwarp as PS
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render import sweep as PSW
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer

from conftest import EX3, EX4
from test_torch_einsum import (  # noqa: F401  (golden_cells: a fixture)
    GH, GN, GW, _jax_jitter, _lut, golden_cells)
from test_torch_slabs import _gate
from torch_sweep_inputs import CWS, H, ORG_Y, TILES, W, seeded_inputs


def _ref_cam(cam):
    return RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                     dir_dv=cam.dir_dv)


# ---------------------------------------------------------------------------
# K5: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lut_kind,tol", [("random", 3e-5), ("smooth", 1e-5)])
def test_k5_plain_matches_pallas(lut_kind, tol):
    """xf_classify_reference (one lerp at k = min(floor(u), N-2)) against
    pallas_xf.xf_classify (the sum of 127 clamp ramps) at (R, C) =
    (16, 256), u over [0, 127] with every integer texel and both ends
    included: the two round differently, by up to 3e-5 on a random LUT."""
    rng = np.random.default_rng(11)
    lut = _lut(lut_kind, rng)
    u = rng.uniform(0.0, 127.0, (16, 256)).astype(np.float32)
    u[0, :128] = np.arange(128, dtype=np.float32)
    u[1, :2] = (0.0, 127.0)
    ref = RX.xf_classify(jnp.asarray(u), jnp.asarray(lut), interpret=True)
    got = PC.xf_classify(torch.from_numpy(u), torch.from_numpy(lut))
    for r, g in zip(ref, got):
        assert g.shape == (16, 256)
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) <= tol
    # at integer texels the lookup is the LUT entry
    assert np.allclose(got[3][0, :128].numpy(), lut[:, 3], atol=tol)


def test_k5_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        PC.xf_classify_cuda(torch.zeros(2, 3), torch.zeros(128, 4))


# ---------------------------------------------------------------------------
# K1's surface stop
# ---------------------------------------------------------------------------

def _stop(d, seed):
    """Per-slab sweep parameters and a per-pixel stop cutting about half
    the slabs; a quarter of the pixels stop exactly at a slab (strict <
    drops that slab)."""
    rng = np.random.default_rng(seed)
    s_ = d["y_pos"].shape[0]
    t_slab = (10.0 + 0.5 * np.arange(s_)).astype(np.float32)
    t_img = rng.uniform(t_slab[0] - 0.2, t_slab[-1] + 0.2,
                        (H, W)).astype(np.float32)
    tie = rng.uniform(size=(H, W)) < 0.25
    t_img[tie] = t_slab[rng.integers(0, s_, (H, W))][tie]
    return t_slab, t_img


def test_sweep_stop_matches_pallas():
    """One chunk with a surface stop through pallas_sweep.sweep_chunk
    (interpret mode) and the port's plain-torch K1, dense classification
    (the knots take the same ok test; render_slabs below runs them): the
    same tolerance as the chunk without a stop (f32 sums in another
    order, ~1e-6)."""
    d = seeded_inputs(3)
    t_slab, t_img = _stop(d, 4)
    dz = np.float32(0.75)
    common = dict(tiles=TILES, adaptive_stride=True)
    ref_rgb, ref_t = RSW.sweep_chunk(
        [([jnp.asarray(v)], jnp.asarray(m)) for v, m in d["mids"]],
        list(ORG_Y), list(CWS), jnp.asarray(d["y_pos"]),
        jnp.asarray(d["sec"]), jnp.asarray(d["live"]),
        [jnp.asarray(d["lut"])], [jnp.asarray(d["dom"][0])], dz, H, W,
        t_stop=(jnp.asarray(t_slab), jnp.asarray(t_img)),
        dot_precision="highest", fuse_mids=False, dma_mids=True,
        concat_levels=False, **common)
    args = ([torch.from_numpy(np.stack([v, m])) for v, m in d["mids"]],
            ORG_Y, CWS, torch.from_numpy(d["y_pos"]),
            torch.from_numpy(d["sec"]), torch.from_numpy(d["live"]),
            [torch.from_numpy(d["lut"])], torch.from_numpy(d["dom"]), dz, H,
            W)
    rgb, t = PSW.sweep_chunk(
        *args, t_stop=(torch.from_numpy(t_slab), torch.from_numpy(t_img)),
        **common)
    ref = np.concatenate([np.asarray(ref_rgb), np.asarray(ref_t)[None]])
    got = torch.cat([rgb, t[None]]).numpy()
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()
    free = torch.cat([x.reshape(-1, H, W)
                      for x in PSW.sweep_chunk(*args, **common)]).numpy()
    # the stop removes samples, and only removes them
    assert (got[3] >= free[3] - 1e-6).all() and (got[3] - free[3]).max() > 0.05


def _scene(text, channels=1):
    lower, level, scal = parse_grids_text(text)
    fields = [scal, 7.0 - scal][:channels]
    scene, bricks, *_ = scene_from_cells(lower, level, fields)
    g = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
    return jax.tree.map(jnp.asarray, g), interop.level_grids_from_reference(
        g, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return {"EX3": _scene(EX3), "EX4": _scene(EX4),
            "EX3_2ch": _scene(EX3, 2)}


def _view(camera, channels=1):
    """24x24 views of the fixtures: aligned, swapped (pixel x along grid
    y), from behind (the sweep flips) and tilted (shear-warp lattice)."""
    eye, up = {"aligned": ((4.0, 4.0, 26.0), (0, 1, 0)),
               "swapped": ((4.0, 4.0, 26.0), (1, 0, 0)),
               "back": ((4.0, 4.0, -18.0), (0, 1, 0)),
               "tilted": ((14.0, 11.0, 17.0), (0, 1, 0))}[camera]
    cam = Camera.look_at(list(eye), [4.0, 4.0, 4.0], list(up), 30.0, 24, 24)
    fs = make_frame_state(_ref_cam(cam), channels,
                          [[0.0, 7.0], [0.0, 9.0]][:channels], dt=1.0,
                          opacity_scale=0.8)
    return cam, fs


def _lattice(cam):
    """A jittered shear-warp lattice of ``cam`` (equal in both packages)
    and its intermediate camera in each."""
    w = h = 24
    iw, ih = PS.inter_dims(w, h)
    sw_r = RS.setup_shearwarp(_ref_cam(cam), 2, w, h, iw, ih)
    sw_p = PS.setup_shearwarp(cam, 2, w, h, iw, ih)
    lat = sw_p.lattice(0.2, -0.3)
    assert np.array_equal(lat[0], sw_r.lattice(0.2, -0.3)[0])
    return lat, sw_p.camera, sw_r.camera, sw_p.width, sw_p.height


@pytest.mark.parametrize("name,camera,stride", [
    ("EX3", "aligned", True), ("EX4", "swapped", False),
    ("EX4", "tilted", True)])
def test_render_slabs_stop_matches_reference(scenes, name, camera, stride):
    """render_slabs_camera with a per-pixel t_stop on the megakernel lane
    (K1's stop) against the JAX package's, HIGHEST dots, under the
    sweep's gate (1e-4 on 99.5% of pixels, 2e-2 on all); the cached frame
    equals the live one (the stop is no camera product)."""
    g_ref, g_port = scenes[name]
    cam, fs_r = _view(camera)
    fs = interop.frame_state_from_reference(fs_r)
    lat, cam_p, cam_r, w, h = (_lattice(cam) if camera == "tilted"
                               else (None, cam, _ref_cam(cam), 24, 24))
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    kw = dict(num_channels=1, nslabs=16, chunk=4, adaptive_stride=stride)
    rcfg = R.SlabConfig(dot_precision="highest", extent_z=extent, **kw)
    pcfg = P.SlabConfig(**kw)
    # stops spread over the volume's depth, in screen pixel order
    rng = np.random.default_rng(5)
    eye_d = float(np.linalg.norm(np.asarray(cam.pos) - 4.0))
    t_stop = rng.uniform(0.7, 1.3, w * h).astype(np.float32) * np.float32(
        eye_d / float(np.linalg.norm(np.asarray(cam_p.dir00))))
    ref = np.asarray(R.render_slabs_camera(g_ref, fs_r, rcfg, cam_r, w, h,
                                           lattice=lat,
                                           t_stop=jnp.asarray(t_stop)))
    got = P.render_slabs_camera(g_port, fs, pcfg, cam_p, w, h, lattice=lat,
                                t_stop=torch.from_numpy(t_stop))
    _gate(got.numpy(), ref, 1e-4)
    full = P.render_slabs_camera(g_port, fs, pcfg, cam_p, w, h, lattice=lat)
    assert float((full[:, 3] - got[:, 3]).max()) > 0.05
    cache = {}
    for _ in range(2):
        cached = P.render_slabs_camera(g_port, fs, pcfg, cam_p, w, h,
                                       lattice=lat, camera_cache=cache,
                                       t_stop=torch.from_numpy(t_stop))
        assert torch.equal(cached, got)
    assert "key" in cache


# ---------------------------------------------------------------------------
# render_slabs_iso vs the JAX package's
# ---------------------------------------------------------------------------

def _iso_fs(fs_r, values, channels=(0, 0)):
    return dataclasses.replace(
        fs_r, iso_enabled=np.asarray([True, True]),
        iso_value=np.asarray(values, np.float32),
        iso_channel=np.asarray(channels, np.int32))


def _iso_pair(g_ref, g_port, fs_r, camera, channels=1, **cfg_kw):
    """Both packages' render_slabs_iso of one view: (rgba, t, n, cos)
    each, numpy, in screen order (a swapped view rendered transposed and
    turned back, as the Renderers do)."""
    cam, _ = _view(camera, channels)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    kw = dict(num_channels=channels, nslabs=16, **cfg_kw)
    rcfg = R.SlabConfig(extent_z=extent, **kw)
    pcfg = P.SlabConfig(chunk=4, **kw)
    fs = interop.frame_state_from_reference(fs_r)
    if camera == "tilted":
        lat, cam_p, cam_r, w, h = _lattice(cam)
    else:
        lat, cam_p, cam_r, w, h = None, cam, _ref_cam(cam), 24, 24
    got = P.render_slabs_iso_camera(g_port, fs, pcfg, cam_p, w, h,
                                    lattice=lat, return_normals=True)
    (swapped,) = (False,) if lat is not None else R.separable_mapping(
        cam_r, 2)
    pos, d00, du, dv = (jnp.asarray(v) for v in R.permute_camera(cam_r, 2))
    rcfg = dataclasses.replace(rcfg, flip=bool(d00[0] < 0))
    if swapped:
        du, dv, w, h = dv, du, h, w
    ref = R.render_slabs_iso(g_ref, fs_r, rcfg, pos, d00, du, dv, w, h,
                             return_depth=True, lattice=lat,
                             return_normals=True)
    ref = [np.asarray(x) for x in ref]
    if swapped:
        # internal rows are screen columns
        ref = [x.reshape(h, w, *x.shape[1:]).swapaxes(0, 1).reshape(x.shape)
               for x in ref]
    return [x.numpy() for x in got], ref


def _iso_gate(got, ref, min_hits=20):
    """Hit masks equal on >= 99.5% of pixels; where both hit, colors and
    normals within 1e-4, depth within 1e-4 |t|."""
    hit_g, hit_r = got[0][:, 3] > 0, ref[0][:, 3] > 0
    assert hit_r.sum() >= min_hits, hit_r.sum()
    assert (hit_g == hit_r).mean() >= 0.995, (hit_g != hit_r).sum()
    both = hit_g & hit_r
    assert np.abs(got[0] - ref[0])[both].max() <= 1e-4
    assert (np.abs(got[1][both] - ref[1][both])
            <= 1e-4 * np.abs(ref[1][both])).all()
    assert np.abs(got[2] - ref[2])[both].max() <= 1e-4
    assert np.abs(got[3] - ref[3])[both].max() <= 1e-4
    assert np.isinf(got[1][~hit_g]).all()


@pytest.mark.parametrize("name,camera,values,shading", [
    ("EX3", "aligned", (3.5, 5.0), True),
    ("EX3", "back", (3.5, 5.0), True),       # flip: back to front
    ("EX3", "aligned", (3.5, 5.0), False),   # unshaded TF color
    ("EX4", "swapped", (0.5, 1.5), True),    # transposed render
    ("EX3", "tilted", (3.5, 5.0), True),     # shear-warp lattice
])
def test_render_slabs_iso_matches_reference(scenes, name, camera, values,
                                            shading):
    g_ref, g_port = scenes[name]
    _, fs_r = _view(camera)
    got, ref = _iso_pair(g_ref, g_port, _iso_fs(fs_r, values), camera,
                         gradient_shading_iso=shading)
    _iso_gate(got, ref)
    if not shading:
        # unshaded: the iso's TF color exactly
        hit = got[0][:, 3] > 0
        assert len(np.unique(got[0][hit, :3], axis=0)) <= 2


def _off_gate(got, ref):
    """Per pixel, whether ``got`` misses ``ref`` under _iso_gate's
    tolerances: a hit flip, or where both hit rgba, normal or cos beyond
    1e-4 or depth beyond 1e-4 |t|."""
    hit_g, hit_r = got[0][:, 3] > 0, ref[0][:, 3] > 0
    with np.errstate(invalid="ignore"):  # inf - inf at misses
        far = np.abs(got[1] - ref[1]) > 1e-4 * np.abs(ref[1])
    far |= np.abs(got[0] - ref[0]).max(1) > 1e-4
    far |= np.abs(got[2] - ref[2]).max(1) > 1e-4
    far |= np.abs(got[3] - ref[3]) > 1e-4
    return (hit_g != hit_r) | (hit_g & hit_r & far)


@pytest.mark.parametrize("camera", ["aligned", "tilted"])
def test_render_slabs_iso_at_a_cell_value(scenes, camera):
    """An iso value equal to a cell value of piecewise-constant data (EX3,
    6.0, beside 3.0 off the cell values): the field crosses on plateaus at
    exactly the iso value, where the gradient is cancellation noise and
    a one-ulp difference of the fields moves the crossing's weights.  Hit
    masks agree on >= 99.5% of pixels.  The pixels outside _iso_gate's
    tolerances are counted, bounded by 15% of the hits, and each is a tie
    in the JAX package's own field: its JAX result moves beyond the same
    tolerances when the iso values move by 8 ulps.  Every other hit agrees
    within them."""
    g_ref, g_port = scenes["EX3"]
    _, fs_r = _view(camera)
    values = (6.0, 3.0)
    got, ref = _iso_pair(g_ref, g_port, _iso_fs(fs_r, values), camera)
    hit_g, hit_r = got[0][:, 3] > 0, ref[0][:, 3] > 0
    assert (hit_g == hit_r).mean() >= 0.995, (hit_g != hit_r).sum()
    off = _off_gate(got, ref)
    tie = np.zeros_like(off)
    for sign in (1, -1):
        moved = tuple(np.float32(v) + sign * 8 * np.spacing(np.float32(v))
                      for v in values)
        _, ref_m = _iso_pair(g_ref, g_port, _iso_fs(fs_r, moved), camera)
        tie |= _off_gate(ref_m, ref)
    n_off = int(off.sum())
    assert 0 < n_off <= 0.15 * hit_r.sum(), (n_off, hit_r.sum())
    assert not (off & ~tie).any(), np.flatnonzero(off & ~tie)
    assert (hit_g & hit_r & ~off).sum() >= 300


def test_render_slabs_iso_colormap_matches_reference(scenes):
    """Two channels, iso on channel 0, hits recolored by channel 1
    through the channel-0 LUT (K5's plain version, once per frame)."""
    g_ref, g_port = scenes["EX3_2ch"]
    _, fs_r = _view("aligned", 2)
    fs_r = _iso_fs(fs_r, (3.5, 5.0))
    got, ref = _iso_pair(g_ref, g_port, fs_r, "aligned", channels=2,
                         colormap_channel=1)
    _iso_gate(got, ref)
    plain, _ = _iso_pair(g_ref, g_port, fs_r, "aligned", channels=2)
    hit = got[0][:, 3] > 0
    assert np.abs(got[0][hit, :3] - plain[0][hit, :3]).max() > 0.05
    with pytest.raises(ValueError):
        _iso_pair(g_ref, g_port, fs_r, "aligned", colormap_channel=1)


def test_clip_interval_ends_at_the_surface():
    """Under the clip box an iso hit ends the volume interval: the box is
    intersected over [0, t_stop |r_w|] (the JAX Renderer's t_end =
    t_stop * rnorm, renderer.py:801-817), bit for bit."""
    from owlexabrick_tpu.render.dvr import ray_box as ref_ray_box
    from owlexabrick_tpu_torch.render.renderer import (
        clip_interval, sweep_rays_world)

    cam = Camera.look_at([GN / 2, GN / 2, GN * 2.1], [GN / 2] * 3,
                         [0, 1, 0], 45.0, GW, GH)
    box = ([GN * 0.25, 0.0, 0.0], [GN, GN, GN * 0.8])
    t0, t1 = clip_interval(2, cam, None, GW, GH, np.eye(3, 4), cam.pos,
                           *box, device="cpu")
    # stop halfway through the box where a ray crosses it, else never
    t_stop = torch.where(torch.isfinite(t0), t0 + 0.5 * (t1 - t0),
                         float("inf"))
    got = clip_interval(2, cam, None, GW, GH, np.eye(3, 4), cam.pos, *box,
                        device="cpu", t_stop=t_stop)
    d, n = (x.numpy() for x in sweep_rays_world(2, cam, None, GW, GH,
                                                np.eye(3, 4), "cpu"))
    hit, c0, c1 = ref_ray_box(
        jnp.asarray(np.broadcast_to(cam.pos, d.shape).astype(np.float32)),
        jnp.asarray(d), jnp.asarray(box[0], jnp.float32),
        jnp.asarray(box[1], jnp.float32), jnp.zeros(GW * GH, jnp.float32),
        jnp.asarray(t_stop.numpy()) * jnp.asarray(n))
    want = (np.asarray(jnp.where(hit, c0, jnp.inf) / n),
            np.asarray(jnp.where(hit, c1, 0.0) / n))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    inside = torch.isfinite(t0)
    assert bool(inside.any()) and bool((got[1][inside] < t1[inside]).all())


# ---------------------------------------------------------------------------
# the Renderer with iso surfaces vs the JAX Renderer's fast path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tilted", [False, True], ids=["aligned", "tilted"])
def test_renderer_iso_matches_jax_renderer(golden_cells, tilted):  # noqa: F811
    """The iso golden's settings (iso 0.55 on [0, 1.05], gradient shading
    iso on) on the 32^3 golden scene, 96x64, 2 frames with the JAX
    Renderer's jitter, through both Renderers' slab fast path: every
    pixel within 1/255, >= 99% bit-exact."""
    lower, level, scal = golden_cells
    scene, *_ = scene_from_cells(lower, level, [scal])
    eye = [GN * 0.9, GN * 0.8, GN * 2.1] if tilted else [GN / 2, GN / 2,
                                                         GN * 2.1]
    cam = RefCamera.look_at(eye, [GN / 2] * 3, [0, 1, 0], 45.0, GW, GH)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7)
    ref = RefRenderer(scene, GW, GH, frame_state=fs,
                      cfg=RefRenderConfig(num_channels=1, iso_surfaces=True))
    port = Renderer((lower, level, scal[None]), GW, GH,
                    cfg=RenderConfig(num_channels=1, iso_surfaces=True),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu", jitter=_jax_jitter)
    for r in (ref, port):
        r.update_iso_values([0.55, 0.0], [0, 0], [True, False])
        assert r.enable_fast_path()
    assert (port._fast[2] == "shearwarp") == tilted
    want = ref.image_uint8(ref.render_frames(2))
    got = port.image_uint8(port.render_frames(2))
    assert (want[..., :3] > 16).any()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99, (
        d.max(), (d == 0).all(-1).mean())
    # the iso surface shows: the frame differs from the DVR-only one
    plain = Renderer((lower, level, scal[None]), GW, GH,
                     frame_state=interop.frame_state_from_reference(fs),
                     device="cpu", jitter=_jax_jitter)
    plain.enable_fast_path()
    dvr = plain.image_uint8(plain.render_frames(2))
    shows = np.abs(dvr.astype(int) - got.astype(int)).max(-1) > 16
    assert shows.mean() > 0.05

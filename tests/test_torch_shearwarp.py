"""PyTorch port, shear-warp: the factorization, the window sizing, the
three warps, the lattice sweep, render_slabs_shearwarp, the
reorientation fallback and the y crop under a lattice camera, each held
against the JAX package on seeded inputs (the two-pass warp against
``warp_pallas`` in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import pallas_warp as RW
from owlexabrick_tpu.render import shearwarp as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import shearwarp as PS
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render import warp as PW
from owlexabrick_tpu_torch.render.camera import Camera

from conftest import EX2, EX3, EX4
from test_torch_slabs import _gate

SIZE = 32
# tests/test_shearwarp.py's cameras (eye, up; at (4, 4, 4), fovy 35),
# then its 178-degree frustum that no axis factorizes
CAMERAS = {
    "tilted": ((14.0, 11.0, 17.0), (0, 1, 0), 35.0),
    "rolled": ((4.0, 4.0, 28.0), (0.4, 1.0, 0.1), 35.0),
    "grazing": ((4.0, 26.0, 9.0), (0, 0, 1), 35.0),
    "down": ((4.0, 26.0, 12.0), (0, 0, 1), 35.0),
    "fov178": ((30.0, 4.0, 4.0), (0, 1, 0), 178.0),
}
# a wide near-diagonal frustum that every shear-warp axis refuses (the
# Renderer's reorientation fallback)
WIDE_DIAGONAL = ((30.0, 25.0, 20.0), (0, 1, 0), 120.0)
# the chip rows' tilted camera: eye (0.9n, 0.8n, 2.2n) at the center of
# the 64^3 headline scene, fovy 45, 1920x1080
HEADLINE_TILTED = ((57.6, 51.2, 140.8), (32.0, 32.0, 32.0), 45.0)


def _cam(name, w=SIZE, h=SIZE):
    eye, up, fov = (WIDE_DIAGONAL if name == "wide_diagonal"
                    else CAMERAS[name])
    return Camera.look_at(list(eye), [4.0, 4.0, 4.0], list(up), fov, w, h)


def _ref_cam(cam):
    return RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                     dir_dv=cam.dir_dv)


def _axis(cam, w, h):
    view = np.asarray(cam.dir00) + 0.5 * (w * np.asarray(cam.dir_du)
                                          + h * np.asarray(cam.dir_dv))
    return P.principal_axis(view)


def _both_sw(cam, w, h, axis=None):
    axis = _axis(cam, w, h) if axis is None else axis
    iw, ih = PS.inter_dims(w, h)
    return (RS.setup_shearwarp(_ref_cam(cam), axis, w, h, iw, ih),
            PS.setup_shearwarp(cam, axis, w, h, iw, ih))


@pytest.mark.parametrize("name", list(CAMERAS))
def test_setup_shearwarp_matches_reference(name):
    """Factorization (float64 host numpy) equal to the reference's;
    the lattice arrays bit for bit."""
    cam = _cam(name)
    axis = 0 if name == "fov178" else None
    assert PS.inter_dims(SIZE, SIZE) == RS.inter_dims(SIZE, SIZE)
    assert PS.inter_dims(1920, 1080) == RS.inter_dims(1920, 1080)
    ref, got = _both_sw(cam, SIZE, SIZE, axis)
    assert (ref is None) == (got is None)
    if name == "fov178":
        assert got is None
        return
    assert (got.width, got.height, got.axis, got.sign, got.screen) == (
        ref.width, ref.height, ref.axis, ref.sign, ref.screen)
    np.testing.assert_allclose(got.hom, ref.hom, rtol=1e-12, atol=0)
    for f in ("u_lo", "u_step", "coef_u", "v_lo", "v_step", "coef_v"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in ("pos", "dir00", "dir_du", "dir_dv"):
        assert np.array_equal(getattr(got.camera, f),
                              np.asarray(getattr(ref.camera, f)))
    for kx, ky in ((0.0, 0.0), (0.37, -0.21)):
        for a, b in zip(got.lattice(kx, ky), ref.lattice(kx, ky)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    moved = interop.shearwarp_from_reference(ref)
    assert np.array_equal(moved.hom, ref.hom)
    assert all(np.array_equal(a, b) for a, b in zip(moved.lattice(0.3, 0.1),
                                                    ref.lattice(0.3, 0.1)))


@pytest.mark.parametrize("name,hw", [
    *[(n, (SIZE, SIZE)) for n in CAMERAS if n != "fov178"],
    *[(n, (128, 256)) for n in CAMERAS if n != "fov178"],
    ("headline_tilted", (1080, 1920)),
])
def test_warp_windows_match_reference(name, hw):
    h, w = hw
    if name == "headline_tilted":
        eye, at, fov = HEADLINE_TILTED
        cam = Camera.look_at(list(eye), list(at), [0, 1, 0], fov, w, h)
    else:
        cam = _cam(name, w, h)
    ref, got = _both_sw(cam, w, h)
    assert PW.warp_windows(got, w, h) == RW.warp_windows(ref, w, h)
    if name == "headline_tilted":
        # the chip rows take K2 at these windows
        assert PW.warp_windows(got, w, h) == (384, 64)


def _tilted_256():
    eye, at, fov = HEADLINE_TILTED
    cam = Camera.look_at(list(eye), list(at), [0, 1, 0], fov, 256, 128)
    ref, got = _both_sw(cam, 256, 128)
    return ref, got, RW.warp_windows(ref, 256, 128)


WARP_KW = dict(jx=0.5 + 0.13, jy=0.5 - 0.21, shift_i=0.13, shift_j=-0.21)


def _smooth_image(iw, ih, c, seed):
    """Seeded smooth [0, 1) field per channel (a few low-frequency waves
    with random phases), like a composited lattice image."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(ih), np.arange(iw), indexing="ij")
    out = []
    for _ in range(c):
        f = np.zeros((ih, iw))
        for _ in range(3):
            kx, ky = rng.uniform(-1, 1, 2) * 2 * np.pi / 96.0
            f += np.sin(kx * ii + ky * jj + rng.uniform(0, 2 * np.pi))
        out.append(0.5 + f / 6.5)
    return np.stack(out, -1).reshape(ih * iw, c).astype(np.float32)


@pytest.mark.parametrize("c", [3, 4])
def test_bilinear_bicubic_match_reference(c):
    ref_sw, sw, _ = _tilted_256()
    img = np.random.default_rng(c).uniform(
        0, 1, (sw.width * sw.height, c)).astype(np.float32)
    for pw, rw in ((PS.warp_bilinear, RS.warp_bilinear),
                   (PS.warp_bicubic, RS.warp_bicubic)):
        got = pw(torch.from_numpy(img), sw, 256, 128, **WARP_KW).numpy()
        want = np.asarray(rw(jnp.asarray(img), ref_sw, 256, 128, **WARP_KW))
        assert got.shape == want.shape == (256 * 128, c)
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("c", [3, 4])
def test_two_pass_matches_pallas(c):
    """warp_two_pass_reference == the JAX package's two-pass Pallas warp
    (interpret mode) within 1e-5, with jitter and lattice shifts, the
    window starts equal.  The image is smooth: XLA's CPU code rounds the
    pass-1 coordinate j a few ulps away from the op-by-op float32 value
    (3.05e-5 at j ~ 152 measured), which a seeded white-noise image turns
    into up to ~6e-5; on a smooth image that stays far below 1e-5."""
    ref_sw, sw, (bi, bj) = _tilted_256()
    assert (bi, bj) == (384, 64)
    img = _smooth_image(sw.width, sw.height, c, seed=c)
    want = np.asarray(RW.warp_pallas(jnp.asarray(img), ref_sw, 256, 128, bi,
                                     bj, interpret=True, **WARP_KW))
    got = PW.warp_two_pass_reference(torch.from_numpy(img), sw, 256, 128,
                                     bi, bj, **WARP_KW).numpy()
    assert got.shape == want.shape == (256 * 128, c)
    assert np.abs(got - want).max() <= 1e-5
    assert float(want[:, :3].max()) > 0.5


def test_two_pass_taps_equal_window_sums():
    """The 4-tap form == the reference's sum over the whole clamped
    window (each tile's b rows or columns from its start), on white
    noise, so every window clamp shows."""
    _, sw, (bi, bj) = _tilted_256()
    w, h, c = 256, 128, 3
    iw, ih = sw.width, sw.height
    img = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (iw * ih, c)).astype(np.float32))
    prm = PW.warp_params(sw, **WARP_KW)
    wj0, wi0 = PW.window_starts(prm, sw, w, h, bi, bj)
    h_pad = -(-h // 8) * 8
    v_img = PW.warp_pass1_reference(img, wj0, prm, sw, h, bj)

    f32 = torch.float32
    planes = img.T.reshape(c, ih, iw)
    vv, aa = torch.arange(h_pad), torch.arange(iw)
    j0w = wj0.long()[vv // 8][:, aa // 128]
    j = PW._j_of_va(prm, vv.to(f32)[:, None] + (prm[13] - h / 2.0),
                    aa.to(f32)[None, :] + prm[14], prm[15])
    j = torch.clamp(torch.clamp(j, 1.0, ih - 2.0 - 1e-4) - j0w.to(f32),
                    1.0, bj - 2.0)
    r = torch.arange(bj, dtype=f32)
    wts = PW._catmull_rom(torch.abs(j[..., None] - r))  # (h_pad, iw, bj)
    win = planes[:, j0w[..., None] + r.long(), aa[None, :, None]]
    assert torch.allclose((wts * win).sum(-1), v_img, atol=2e-6, rtol=0)

    out = PW.warp_pass2_reference(v_img, wi0, prm, sw, w, h, bi)
    uu, vr = torch.arange(w), torch.arange(h)
    i0w = wi0.long()[vr // 8][:, uu // 128]
    u = uu.to(f32)[None, :] + (prm[12] - w / 2.0)
    v = vr.to(f32)[:, None] + (prm[13] - h / 2.0)
    i = PW._safe_div(prm[0] * u + prm[1] * v + prm[2],
                     prm[3] * u + prm[4] * v + prm[5]) - prm[14]
    i = torch.clamp(torch.clamp(i, 1.0, iw - 2.0 - 1e-4) - i0w.to(f32),
                    1.0, bi - 2.0)
    r = torch.arange(bi, dtype=f32)
    want = torch.zeros(c, h, w)
    for y in range(h):
        wts = PW._catmull_rom(torch.abs(i[y, :, None] - r))  # (W, bi)
        seg = v_img[:, y, i0w[y, :, None] + r.long()]  # (C, W, bi)
        want[:, y] = (wts * seg).sum(-1)
    want = torch.clamp(want, min=0.0).reshape(c, -1).T
    assert torch.allclose(out, want, atol=2e-6, rtol=0)
    # the two-pass filter is not the tensor-product bicubic here
    bic = PS.warp_bicubic(img, sw, w, h, **WARP_KW)
    assert float((bic - out).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def scenes():
    """Per fixture and sweep axis: (reference grids, port grids)."""
    out = {}
    for name, text in (("EX2", EX2), ("EX3", EX3), ("EX4", EX4)):
        lower, level, scal = parse_grids_text(text)
        scene, bricks, *_ = scene_from_cells(lower, level, [scal])
        for axis in range(3):
            g = R.build_level_grids(bricks, scene.scalars, axis=axis,
                                    device=False)
            out[name, axis] = (g, interop.level_grids_from_reference(
                g, device="cpu"))
    return out


def _fs(cam, dt=1.0):
    return make_frame_state(_ref_cam(cam), 1, [[0.0, 7.0]], dt=dt,
                            opacity_scale=0.8)


@pytest.mark.parametrize("name,prec", [("EX3", "highest"), ("EX4", "highest"),
                                       ("EX4", "hi_lo")])
def test_render_slabs_camera_lattice_matches_reference(scenes, name, prec):
    """The sweep of a lattice camera (24x24 screen, 40x40 lattice, a
    jittered lattice phase): 1e-4 on 99.5% of pixels for highest, 2e-4
    for the reference's default hi_lo.  (On EX3 the reference's hi_lo
    frame is itself 3.0e-4 from its highest frame at this camera, so
    EX3 is held to highest.)"""
    cam = _cam("tilted", 24, 24)
    ref_sw, sw = _both_sw(cam, 24, 24)
    g_ref, g_port = scenes[name, sw.axis]
    fs = _fs(cam)
    base = dict(num_channels=1, nslabs=16, chunk=4, adaptive_stride=True)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    rcfg = R.SlabConfig(dot_precision=prec, extent_z=extent, **base)
    lat = sw.lattice(0.37, -0.21)
    ref = np.asarray(R.render_slabs_camera(
        g_ref, fs, rcfg, ref_sw.camera, sw.width, sw.height, lattice=lat))
    got = P.render_slabs_camera(
        g_port, interop.frame_state_from_reference(fs), P.SlabConfig(**base),
        sw.camera, sw.width, sw.height, lattice=lat).numpy()
    assert ref[:, 3].max() > 0.5
    _gate(got, ref, 1e-4 if prec == "highest" else 2e-4)


def test_lattice_camera_cache_keys_on_the_lattice(scenes):
    """The camera cache serves a lattice camera's products only for the
    same lattice: a new phase rebuilds, and every frame equals the
    uncached one."""
    cam = _cam("tilted", 24, 24)
    _, sw = _both_sw(cam, 24, 24)
    _, g = scenes["EX3", sw.axis]
    fs = interop.frame_state_from_reference(_fs(cam))
    cfg = P.SlabConfig(nslabs=16, chunk=4, adaptive_stride=True)
    cache = {}
    keys = []
    for phase in ((0.0, 0.0), (0.0, 0.0), (0.25, 0.1)):
        lat = sw.lattice(*phase)
        live = P.render_slabs_camera(g, fs, cfg, sw.camera, sw.width,
                                     sw.height, lattice=lat)
        got = P.render_slabs_camera(g, fs, cfg, sw.camera, sw.width,
                                    sw.height, camera_cache=cache,
                                    lattice=lat)
        assert torch.equal(live, got)
        keys.append(cache["key"])
    assert keys[1] is keys[0] and keys[2] != keys[0]


@pytest.mark.parametrize("name,eye,at,fov,hw", [
    ("EX2", (14.0, 11.0, 17.0), (4.0, 4.0, 4.0), 35.0, (SIZE, SIZE)),
    ("EX3", (16.0, 12.0, 19.0), (4.0, 4.0, 4.0), 35.0, (SIZE, SIZE)),
    # 256x128: warp_windows admits (384, 64), so the two-pass warp runs
    ("EX3", (7.2, 6.4, 17.6), (4.0, 2.0, 2.0), 45.0, (128, 256)),
], ids=["EX2", "EX3", "EX3-two-pass"])
def test_render_slabs_shearwarp_matches_reference(scenes, name, eye, at,
                                                  fov, hw):
    """render_slabs_shearwarp (at 32x32: tests/test_shearwarp.py's scenes
    and cameras, the bicubic warp): 2e-4 on 99.5% of pixels, 2e-2 on
    all."""
    h, w = hw
    cam = Camera.look_at(list(eye), list(at), [0, 1, 0], fov, w, h)
    axis = _axis(cam, w, h)
    g_ref, g_port = scenes[name, axis]
    ref_sw, sw = _both_sw(cam, w, h)
    assert (PW.warp_windows(sw, w, h) is not None) == (w > SIZE)
    dt = 0.25 if w == SIZE else 0.5
    fs = _fs(cam, dt=dt)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    base = dict(num_channels=1, nslabs=int(np.ceil(extent / dt)), chunk=12)
    ref = np.asarray(RS.render_slabs_shearwarp(
        g_ref, fs, R.SlabConfig(extent_z=extent, **base), _ref_cam(cam),
        w, h))
    got = PS.render_slabs_shearwarp(
        g_port, interop.frame_state_from_reference(fs), P.SlabConfig(**base),
        cam, w, h).numpy()
    assert ref[:, 3].max() > 0.3
    _gate(got, ref, 2e-4)


def test_render_slabs_shearwarp_refuses_oblique(scenes):
    cam = _cam("fov178")
    _, g = scenes["EX2", 0]
    fs = interop.frame_state_from_reference(_fs(cam))
    with pytest.raises(ValueError):
        PS.render_slabs_shearwarp(g, fs, P.SlabConfig(nslabs=8), cam, SIZE,
                                  SIZE)


def test_reorient_grids_matches_reference(scenes):
    """The reorientation fallback's rotated tables within 1e-6 of the
    reference's, its frame and camera equal."""
    cam = _cam("wide_diagonal")
    g_ref, g_port = scenes["EX3", 2]
    r_grids, r_cam = R.reorient_grids(g_ref, _ref_cam(cam))
    p_grids, p_cam = P.reorient_grids(g_port, cam)
    assert p_grids.levels == tuple(r_grids.levels)
    assert p_grids.y_bin == tuple(r_grids.y_bin) and p_grids.axis == 2
    for f in ("vals", "masks", "vrange_zy"):
        for a, b in zip(getattr(r_grids, f), getattr(p_grids, f)):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape
            fin = np.isfinite(a)
            assert np.array_equal(fin, np.isfinite(b)) and np.array_equal(
                a[~fin], b[~fin]), f
            assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= 1e-6, f
    zr_a, zr_b = np.asarray(r_grids.zranges), p_grids.zranges.numpy()
    fin = np.isfinite(zr_a)
    assert np.array_equal(zr_a[~fin], zr_b[~fin])
    assert np.abs(zr_a[fin] - zr_b[fin]).max(initial=0.0) <= 1e-6
    for a, b in zip(r_grids.origins, p_grids.origins):
        assert np.array_equal(np.asarray(a), b)
    assert np.array_equal(np.asarray(r_grids.bounds_lo), p_grids.bounds_lo)
    assert np.array_equal(np.asarray(r_grids.bounds_hi), p_grids.bounds_hi)
    for f in ("pos", "dir00", "dir_du", "dir_dv"):
        assert np.array_equal(getattr(p_cam, f), getattr(r_cam, f))
    assert P.check_separable(p_cam, 2)


@pytest.mark.parametrize("mid_orbit", [False, True],
                         ids=["enable", "mid_orbit"])
def test_renderers_take_reorient_fallback_for_oblique_frustum(mid_orbit):
    """A frustum every shear-warp axis refuses goes through the
    reorientation preview in both Renderers — chosen when the fast path
    is enabled, or per frame when an orbit on shear-warp reaches it —
    and the port's frame is the reference's within display precision."""
    from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
    from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer

    import chip_smoke

    lower, level, scal = parse_grids_text(EX2)
    scene, *_ = scene_from_cells(lower, level, [scal])
    cam = _cam("wide_diagonal")
    start = _cam("tilted") if mid_orbit else cam
    fs = make_frame_state(_ref_cam(start), 1, [[0.0, 7.0]], dt=0.5,
                          opacity_scale=0.5)
    ref = RefRenderer(scene, SIZE, SIZE, cfg=RefRenderConfig(num_channels=1),
                      frame_state=fs)
    port = Renderer((lower, level, scal[None]), SIZE, SIZE,
                    cfg=RenderConfig(num_channels=1),
                    frame_state=interop.frame_state_from_reference(fs),
                    device="cpu",
                    jitter=chip_smoke.GOLDEN_JITTER.__getitem__)
    assert port._pick_shearwarp(_cam("wide_diagonal")) is None
    for r, cam_type in ((ref, RefCamera), (port, Camera)):
        assert r.enable_fast_path()
        if mid_orbit:
            assert r._fast[2] == "shearwarp"
            r.update_camera(_ref_cam(cam) if r is ref else cam)
        else:
            assert isinstance(r._fast[2], cam_type)
    want = ref.image_uint8(ref.render())
    got = port.image_uint8(port.render())
    d = np.abs(got.astype(int) - want.astype(int))
    assert (want[..., :3] > 16).any()
    assert d.max() <= 1 and (d == 0).all(-1).mean() >= 0.99


@pytest.mark.parametrize("lattice", [False, True],
                         ids=["zoomed", "zoomed_lattice"])
def test_y_crop_exact(lattice):
    """A zoomed camera engages the y crop; under a lattice camera the
    crop and the y-window hints take ry from the lattice.  Both equal
    the reference's, and the cropped render equals the uncropped one
    within 1e-6."""
    from test_torch_host import _golden_scene_grids

    g_ref, g_port = _golden_scene_grids()
    h, w = 48, 96
    if lattice:
        cam = Camera.look_at([22.0, 24.0, 50.0], [16.0, 20.0, 16.0],
                             [0, 1, 0], 8.0, w, h)
        _, sw = _both_sw(cam, w, h)
        assert sw.axis == 2
        lat = sw.lattice(0.2, -0.3)
        cam_s, w, h = sw.camera, sw.width, sw.height
    else:
        cam_s = Camera.look_at([16.0, 20.0, 40.0], [16.0, 20.0, 16.0],
                               [0, 1, 0], 8.0, w, h)
        lat = None
    pos, d00, du, dv = P.permute_camera(cam_s, 2)
    kw = dict(num_channels=1, nslabs=24, chunk=4)
    rcfg = R.SlabConfig(**kw)
    pcfg = P.SlabConfig(**kw)
    crop = P.y_crop_for_camera(g_port, pcfg, pos, d00, dv, h, lattice=lat)
    assert crop is not None
    assert crop == R.y_crop_for_camera(g_ref, rcfg, pos, d00, dv, h,
                                       lattice=lat)
    hints = P.ky_hints_for_camera(g_port, pcfg, pos, d00, dv, h, w,
                                  lattice=lat)
    assert hints == R.ky_hints_for_camera(g_ref, rcfg, pos, d00, dv, h, w,
                                          lattice=lat)
    fs = interop.frame_state_from_reference(make_frame_state(
        _ref_cam(cam_s), 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7))
    full = P.render_slabs(g_port, fs, pcfg, pos, d00, du, dv, w, h,
                          ky_hints=hints, lattice=lat)
    cropped = P.render_slabs(g_port, fs, pcfg, pos, d00, du, dv, w, h,
                             ky_hints=hints, lattice=lat, y_crop=crop)
    assert float(full[:, 3].max()) > 0.3
    assert float((full - cropped).abs().max()) <= 1e-6

"""PyTorch port, the einsum lane's one-channel clip route: K3 from the
mids.  The route builds each occupied level's mids of the chunk's live
slabs (the z lerp in torch, the x lerp by K6's plain version) and K3's
plain version does the y lerp, the clip masks and the composite.  Its
frames and chunks are held bit for bit against the route it replaced
(``_EinsumLane.fields``, the clip masks and ``composite_chunk_reference``)
on aligned, swapped and shear-warp lattice cameras, and the frames
against the JAX package's ``render_slabs_camera``.  Inputs are made from
a seed with numpy."""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import shearwarp as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import classify as PC
from owlexabrick_tpu_torch.render import mids as PM
from owlexabrick_tpu_torch.render import shearwarp as PS
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.renderer import clip_interval

from conftest import EX3
from test_torch_slabs import _gate
from torch_sweep_inputs import k3_mids_inputs, k6_level_cases

# a level-0 block below z = 8 and a level-1 block above z = 24, nothing
# between: chunks in one block skip the other level, chunks in the gap
# have no live slab, and chunks across a block's end have dead slabs
GAP = ("0 0 0 12 12 8 0 0 1 2 3 4 5 6 7\n"
       "0 0 24 6 6 4 1 7 6 5 4 3 2 1 0\n")
# the box cuts every scene's far half in x and part of its z range
BOX = {"GAP": ([3.0, 0.0, 0.0], [9.0, 12.0, 28.0]),
       "EX3": ([2.5, 0.0, 0.0], [8.0, 8.0, 5.5])}
# W = 37: no multiple of K3's 32-column block
W, H = 37, 24


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, text in (("GAP", GAP), ("EX3", EX3)):
        lower, level, scal = parse_grids_text(text)
        scene, bricks, *_ = scene_from_cells(lower, level, [scal])
        g = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
        out[name] = (jax.tree.map(jnp.asarray, g),
                     interop.level_grids_from_reference(g, device="cpu"))
    return out


def _view(name, camera):
    """(camera to render, JAX camera, width, height, lattice, frame state,
    config, clip interval) of one case."""
    t, hi = (6.0, 32.0) if name == "GAP" else (4.0, 8.0)
    c = hi / 2
    eye, up = {"aligned": ((t, t, 3 * hi), (0, 1, 0)),
               "swapped": ((t, t, 3 * hi), (1, 0, 0)),
               "tilted": ((t + 9.0, t + 6.0, 2.5 * hi), (0, 1, 0))}[camera]
    cam = Camera.look_at(list(eye), [t, t, c], list(up), 30.0, W, H)
    ref_cam = RefCamera(pos=cam.pos, dir00=cam.dir00, dir_du=cam.dir_du,
                        dir_dv=cam.dir_dv)
    w, h, lat = W, H, None
    if camera == "tilted":
        iw, ih = PS.inter_dims(W, H)
        sw_p = PS.setup_shearwarp(cam, 2, W, H, iw, ih)
        sw_r = RS.setup_shearwarp(ref_cam, 2, W, H, iw, ih)
        lat = sw_p.lattice(0.2, -0.3)
        cam, ref_cam, w, h = sw_p.camera, sw_r.camera, sw_p.width, sw_p.height
    fs_r = make_frame_state(ref_cam, 1, [[0.0, 7.0]], dt=1.0,
                            opacity_scale=0.8)
    t0, t1 = clip_interval(2, cam, lat, w, h, np.eye(3, 4), cam.pos,
                           *BOX[name], device="cpu")
    assert bool(torch.isinf(t0).any()) and bool(torch.isfinite(t0).any())
    # 30 slabs in chunks of 4: the last chunk holds 2 padded, dead slabs
    return (cam, ref_cam, w, h, lat, fs_r, dict(nslabs=30, chunk=4),
            dict(t_start=t0, t_stop=t1))


def _old_route(lane, z_s, occ_s, scale, live):
    """The route K3 from the mids replaced: the (S, H, W) fields, the clip
    masks, then composite_chunk_reference over the chunk's slabs."""
    sw, swv, _, _ = lane.fields(z_s, occ_s, scale)
    sc = scale[:, None, None]
    if lane.t_stop is not None:
        sw = torch.where(sc < lane.t_stop[None], sw, 0.0)
    if lane.t_start is not None:
        sw = torch.where(sc >= lane.t_start[None], sw, 0.0)
    return PC.composite_chunk_reference(sw, swv[0], lane.sec, live,
                                        lane.luts[0], lane.domains[0],
                                        lane.dz)


def _render(scenes, name, camera):
    g_port = scenes[name][1]
    cam, _, w, h, lat, fs_r, kw, interval = _view(name, camera)
    return P.render_slabs_camera(
        g_port, interop.frame_state_from_reference(fs_r),
        P.SlabConfig(**kw), cam, w, h, lattice=lat, **interval)


@pytest.mark.parametrize("name,camera", [
    ("GAP", "aligned"), ("GAP", "swapped"), ("GAP", "tilted"),
    ("EX3", "aligned")])
def test_k3_mids_chunks_equal_fields_route(scenes, monkeypatch, name,
                                           camera):
    """Every chunk of a one-channel clip frame: K3's plain version fed by
    the route's z and x stages equals the fields route bit for bit, on
    aligned, swapped (pixel x along grid y) and lattice cameras, a clip
    interval with infinite and finite bounds, W = 37, dead slabs and (GAP)
    a level skipped by occupancy."""
    seen = []
    chunk = P._EinsumLane.chunk

    def spy(lane, z_s, occ_s, scale, live):
        got = chunk(lane, z_s, occ_s, scale, live)
        want = _old_route(lane, z_s, occ_s, scale, live)
        skipped = any(not bool(o.any()) for o in occ_s)
        seen.append((got, want, bool(live.all()), skipped))
        return got

    monkeypatch.setattr(P._EinsumLane, "chunk", spy)
    frame = _render(scenes, name, camera)
    assert float(frame[:, 3].max()) > 0.3
    assert len(seen) >= 3
    for (rgb, trans), (rgb_w, trans_w), _, _ in seen:
        assert torch.equal(rgb, rgb_w) and torch.equal(trans, trans_w)
    assert not all(s[2] for s in seen)  # a chunk with dead slabs
    if name == "GAP":
        assert any(s[3] for s in seen)  # a chunk that skips a level
        assert len(seen) < 8  # the gap's chunks have no live slab


@pytest.mark.parametrize("camera", ["aligned", "tilted"])
def test_k3_mids_frame_equals_fields_route(scenes, monkeypatch, camera):
    """A one-channel clip frame through render_slabs_camera equals the
    frame the fields route assembles, bit for bit."""
    got = _render(scenes, "GAP", camera)
    monkeypatch.setattr(P._EinsumLane, "chunk", _old_route)
    want = _render(scenes, "GAP", camera)
    assert torch.equal(got, want)


def test_clip_route_builds_no_fields(scenes, monkeypatch):
    """The one-channel clip route never calls ``fields``: no (S, H, W)
    sw / swv is built."""

    def refuse(*a, **k):
        raise AssertionError("fields called on the one-channel clip route")

    monkeypatch.setattr(P._EinsumLane, "fields", refuse)
    assert float(_render(scenes, "GAP", "aligned")[:, 3].max()) > 0.3


@pytest.mark.parametrize("camera", ["aligned", "tilted"])
def test_k3_mids_route_matches_reference(scenes, camera):
    """The gap scene's one-channel clip frame (skipped levels, dead
    slabs, chunks with no live slab) against the JAX package's
    ``render_slabs_camera`` under the sweep's gate (1e-4 on 99.5% of
    pixels, 2e-2 on all)."""
    g_ref = scenes["GAP"][0]
    _, ref_cam, w, h, lat, fs_r, kw, interval = _view("GAP", camera)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    ref = np.asarray(R.render_slabs_camera(
        g_ref, fs_r, R.SlabConfig(dot_precision="highest", extent_z=extent,
                                  num_channels=1, **kw), ref_cam, w, h,
        lattice=lat, **{k: jnp.asarray(v.numpy())
                        for k, v in interval.items()}))
    assert ref[:, 3].max() > 0.3
    _gate(_render(scenes, "GAP", camera).numpy(), ref, 1e-4)


@pytest.mark.parametrize("case", ["levels4", "levels9", "ragged_w",
                                  "wide_window"])
def test_k6_plain_equals_lerp_x(case):
    """K6's plain version is the fields route's x stage: on the same
    z-lerped blocks and columns, ``xresample_mids_reference`` equals
    ``_lerp_x`` with ``tent_taps``' weights, bit for bit."""
    zvs_l, qx_l = k6_level_cases()[case]
    for z, q in zip(zvs_l, qx_l):
        zt, qt = torch.from_numpy(z), torch.from_numpy(q)
        ix, wx, _ = PM.tent_taps(qt, z.shape[3])
        got = PM.xresample_mids_reference(zt, qt)
        for c in range(z.shape[0]):
            assert torch.equal(got[c], P._lerp_x(zt[c], ix, wx, q.shape[1]))


@pytest.mark.parametrize("case", ["levels1", "levels4", "levels8",
                                  "ragged_w", "all_infinite",
                                  "no_interval", "levels9", "levels12"])
def test_mids_fields_reference_matches_numpy(case):
    """K3's y stage and clip masks in plain torch against the same
    float32 arithmetic in numpy (per level in order, acc + (w0 a + w1
    b), then the masks), bit for bit; the composite is
    composite_chunk_reference's over every slab."""
    d = k3_mids_inputs(case)
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in d.items() if k not in ("mids", "taps")}
    mids = [torch.from_numpy(m) for m in d["mids"]]
    taps = [torch.from_numpy(tp) for tp in d["taps"]]
    h, w = d["sec"].shape
    sw, swv = PC.mids_fields_reference(mids, taps, t["scale"], t["t_start"],
                                       t["t_stop"], h, w)
    s_ = d["scale"].shape[0]
    want = np.zeros((2, s_, h, w), np.float32)
    cols = np.arange(w)
    for mid, tp in zip(d["mids"], d["taps"]):
        r0, r1 = tp[..., 2].astype(np.int64), tp[..., 3].astype(np.int64)
        for s in range(s_):
            for c in range(2):
                a = mid[c, s][r0[s][:, None], cols[None, :]]
                b = mid[c, s][r1[s][:, None], cols[None, :]]
                want[c, s] = want[c, s] + (tp[s, :, 0, None] * a
                                           + tp[s, :, 1, None] * b)
    sc = d["scale"][:, None, None]
    if d["t_stop"] is not None:
        want[1] = np.where(sc < d["t_stop"][None], want[1], 0.0)
        want[1] = np.where(sc >= d["t_start"][None], want[1], 0.0)
    assert torch.equal(swv, torch.from_numpy(want[0]))
    assert torch.equal(sw, torch.from_numpy(want[1]))
    if case == "all_infinite":
        assert not bool(sw.any())
    else:
        assert float((sw > 1e-20).float().mean()) > 0.1
    rgb, trans = PC.composite_mids(mids, taps, t["scale"], t["t_start"],
                                   t["t_stop"], t["sec"], t["lut"],
                                   d["dom"], d["dz"])
    rgb_w, trans_w = PC.composite_chunk_reference(
        sw, swv, t["sec"], torch.ones(s_, dtype=torch.bool), t["lut"],
        d["dom"], d["dz"])
    assert torch.equal(rgb, rgb_w) and torch.equal(trans, trans_w)
    assert (case == "all_infinite") == bool((trans == 1.0).all())


def test_composite_mids_without_levels_is_transparent():
    """A chunk whose levels are all skipped: K3's plain version gives
    rgb 0 and transmittance 1."""
    d = k3_mids_inputs("levels1")
    rgb, trans = PC.composite_mids([], [], torch.from_numpy(d["scale"]),
                                   None, None, torch.from_numpy(d["sec"]),
                                   torch.from_numpy(d["lut"]), d["dom"],
                                   d["dz"])
    assert not bool(rgb.any()) and bool((trans == 1.0).all())

"""PyTorch port, K6 and the camera products' x stage: K6's plain version
against the JAX package's Pallas ``xresample_mids`` (interpret mode),
and ``render_slabs_camera``, whose megakernel lane takes its x stage
through K6, against the JAX package's ``SlabConfig(kernel_mids=True)``
(the ``test_kernel_mids_agrees`` fixture) and against both of its lanes
on aligned, swapped and shear-warp lattice cameras, live and cached.
Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import pallas_mids as RM
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import mids as PM
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render.camera import Camera

from test_torch_iso import _lattice, _ref_cam
from torch_sweep_inputs import k6_level_cases

# tests/test_slabs.py::test_kernel_mids_agrees's scene: a 16^3 level-0
# block and an 8^3 level-1 block above it
TEXT = ("0 0 0 16 16 16 0 0 1 2 3 4 5 6 7\n"
        "0 0 16 8 8 8 1 3 4 5 6 3 4 5 6\n")


def test_k6_plain_matches_pallas():
    """xresample_mids_reference against pallas_mids.xresample_mids
    (HIGHEST, interpret mode) on seeded blocks with ny = 13 (no multiple
    of 8) and W = 200 (no multiple of the tile): the JAX output cropped
    to ny rows and W columns, every value within 1e-6.  qx runs past
    both ends of the lattice and sits exactly on lattice points."""
    rng = np.random.default_rng(6)
    s_, ny, nx, w, tc = 3, 13, 21, 200, 128
    zvs = rng.uniform(-1.0, 2.0, (3, s_, ny, nx)).astype(np.float32)
    qx = np.sort(rng.uniform(-2.5, nx + 1.5, (s_, w)), 1).astype(np.float32)
    qx[:, 100:110] = np.arange(10, dtype=np.float32)
    qx_p = np.pad(qx, ((0, 0), (0, 2 * tc - w)), constant_values=-2.0)
    ref = RM.xresample_mids([jnp.asarray(z) for z in zvs], jnp.asarray(qx_p),
                            tc, interpret=True)
    got = PM.xresample_mids(torch.from_numpy(zvs), torch.from_numpy(qx))
    assert got.shape == (3, s_, ny, w)
    for c in range(3):
        want = np.asarray(ref[c])[:, :ny, :w]
        assert float(np.abs(got[c].numpy() - want).max()) <= 1e-6
    assert float(got.abs().max()) > 0.5


@pytest.mark.parametrize("case", ["levels4", "levels9", "ragged_w",
                                  "wide_window"])
def test_k6_levels_plain_matches_pallas(case):
    """The level-batched plain version against the per-level plain
    version (equal) and against pallas_mids.xresample_mids per level
    (HIGHEST, interpret mode; qx padded at -2 to the tile multiple, the
    output cropped), every value within 1e-6."""
    zvs_l, qx_l = k6_level_cases()[case]
    zt = [torch.from_numpy(z) for z in zvs_l]
    qt = [torch.from_numpy(q) for q in qx_l]
    got = PM.xresample_mids_levels(zt, qt)
    assert len(got) == len(zvs_l)
    tc = 128
    for z, q, g in zip(zvs_l, qx_l, got):
        c1, s_, ny, _ = z.shape
        w = q.shape[1]
        assert torch.equal(g, PM.xresample_mids_reference(
            torch.from_numpy(z), torch.from_numpy(q)))
        qp = np.pad(q, ((0, 0), (0, -(-w // tc) * tc - w)),
                    constant_values=-2.0)
        ref = RM.xresample_mids([jnp.asarray(v) for v in z],
                                jnp.asarray(qp), tc, interpret=True)
        assert g.shape == (c1, s_, ny, w)
        for c in range(c1):
            want = np.asarray(ref[c])[:, :ny, :w]
            assert float(np.abs(g[c].numpy() - want).max()) <= 1e-6


def test_k6_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        PM.xresample_mids_levels_cuda([torch.zeros(2, 1, 3, 4)],
                                      [torch.zeros(1, 5)])
    with pytest.raises(ValueError):  # levels that differ in S
        PM.xresample_mids_levels([torch.zeros(2, 1, 3, 4),
                                  torch.zeros(2, 2, 3, 4)],
                                 [torch.zeros(1, 5), torch.zeros(2, 5)])


@pytest.fixture(scope="module")
def scene():
    lower, level, scal = parse_grids_text(TEXT)
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    g = R.build_level_grids(bricks, sc.scalars, axis=2, device=False)
    cam = Camera.look_at([8.0, 8.0, 80.0], [8.0, 8.0, 16.0], [0, 1, 0],
                         10.0, 32, 32)
    fs = make_frame_state(_ref_cam(cam), 1, [[0.0, 7.0]], dt=0.7,
                          opacity_scale=0.8)
    return (jax.tree.map(jnp.asarray, g),
            interop.level_grids_from_reference(g, device="cpu"), cam, fs)


@pytest.mark.parametrize("stride", [True, False])
def test_default_lane_matches_kernel_mids_reference(scene, stride):
    """The port's megakernel lane (x stage through K6's plain version)
    against the JAX package's kernel-mids lane (HIGHEST dots and K6 at
    HIGHEST) on test_kernel_mids_agrees's scene, camera and frame state,
    every value within 5e-5 (that test's tolerance)."""
    g_ref, g_port, cam, fs_r = scene
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    kw = dict(num_channels=1, nslabs=int(np.ceil(extent / 0.7)),
              adaptive_stride=stride)
    ref = np.asarray(R.render_slabs_camera(
        g_ref, fs_r, R.SlabConfig(dot_precision="highest", extent_z=extent,
                                  kernel_mids=True, **kw),
        _ref_cam(cam), 32, 32))
    got = P.render_slabs_camera(g_port, interop.frame_state_from_reference(
        fs_r), P.SlabConfig(**kw), cam, 32, 32).numpy()
    assert ref[:, 3].max() > 0.2
    assert float(np.abs(got - ref).max()) <= 5e-5


@pytest.mark.parametrize("camera", ["aligned", "swapped", "tilted"])
def test_default_lane_matches_both_reference_lanes(scene, camera):
    """24x24 views of the same scene (aligned, swapped: pixel x along grid
    y, and a jittered shear-warp lattice): the port's frame, live and
    twice through the camera cache, against the JAX package's kernel-mids
    lane and its default (einsum x stage) lane, HIGHEST dots, every value
    within 5e-5; the cached frames equal the live one."""
    g_ref, g_port, _, fs_r = scene
    fs = interop.frame_state_from_reference(fs_r)
    up = [1, 0, 0] if camera == "swapped" else [0, 1, 0]
    eye = [30.0, 24.0, 60.0] if camera == "tilted" else [8.0, 8.0, 80.0]
    cam = Camera.look_at(eye, [8.0, 8.0, 16.0], up, 20.0, 24, 24)
    lat, cam_p, cam_r, w, h = (_lattice(cam) if camera == "tilted"
                               else (None, cam, _ref_cam(cam), 24, 24))
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    kw = dict(num_channels=1, nslabs=24, chunk=4, adaptive_stride=True)
    live = P.render_slabs_camera(g_port, fs, P.SlabConfig(**kw), cam_p, w, h,
                                 lattice=lat)
    cache = {}
    for _ in range(2):
        cached = P.render_slabs_camera(g_port, fs, P.SlabConfig(**kw), cam_p,
                                       w, h, lattice=lat, camera_cache=cache)
        assert torch.equal(cached, live)
    assert "key" in cache and float(live[:, 3].max()) > 0.2
    for kmid in (True, False):
        ref = np.asarray(R.render_slabs_camera(
            g_ref, fs_r, R.SlabConfig(dot_precision="highest",
                                      extent_z=extent, kernel_mids=kmid,
                                      **kw), cam_r, w, h, lattice=lat))
        assert float(np.abs(live.numpy() - ref).max()) <= 5e-5, kmid

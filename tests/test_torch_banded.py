"""PyTorch port, the out-of-core z-banded sweep: ``render_slabs_banded``
of the port against the JAX package's (2 and 3 bands, the sweep front to
back and flipped), against the port's own unbanded frame, its
``mem_stats`` and its host-grid cache."""

import dataclasses

import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as JCamera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render.camera import Camera

from conftest import EX3
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 20
# EX3 plus a level-2 block ahead of it in z: three levels, and bands
# that hold different brick subsets
SCENE = EX3 + "0 0 12 2 2 1 2 3\n"


@pytest.fixture(scope="module")
def scene():
    lower, level, scal = parse_grids_text(SCENE)
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    return bricks, np.asarray(sc.scalars)


def _case(eye, at=(4.0, 4.0, 6.0)):
    args = (eye, list(at), [0, 1, 0], 35.0, SIZE, SIZE)
    fs = make_frame_state(JCamera.look_at(*args), 1, [[0.0, 7.0]], dt=0.4,
                          opacity_scale=0.7)
    return (JCamera.look_at(*args), fs, Camera.look_at(*args),
            interop.frame_state_from_reference(fs))


def _gate(got, ref, tol=2e-4):
    """The port's slab gate against the JAX package (its default hi_lo
    MXU precision): within ``tol`` on >= 99.5% of pixels, 2e-2 on all."""
    d = np.abs(got - ref).max(1)
    assert d.max() <= 2e-2, d.max()
    assert (d <= tol).mean() >= 0.995, ((d > tol).mean(), d.max())


@pytest.mark.parametrize("n_bands", [2, 3])
@pytest.mark.parametrize("eye", [[4.0, 4.0, 30.0], [4.0, 4.0, -20.0]],
                         ids=["front", "flipped"])
def test_banded_matches_reference(scene, n_bands, eye):
    bricks, scalars = scene
    jcam, jfs, cam, fs = _case(eye)
    ns = 36
    ref = np.asarray(R.render_slabs_banded(
        bricks, scalars, jfs, R.SlabConfig(num_channels=1, nslabs=ns),
        jcam, SIZE, SIZE, n_bands=n_bands, reuse=False))
    got = P.render_slabs_banded(
        bricks, scalars, fs, P.SlabConfig(num_channels=1, nslabs=ns), cam,
        SIZE, SIZE, n_bands=n_bands, reuse=False, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (SIZE * SIZE, 4)
    assert ref[:, 3].max() > 0.5
    _gate(got.numpy(), ref)


@pytest.mark.parametrize("eye", [[4.0, 4.0, 30.0], [4.0, 4.0, -20.0]],
                         ids=["front", "flipped"])
def test_banded_matches_unbanded(scene, eye):
    """Band boundaries lie on the global slab lattice: the banded frame
    is the single-pass frame to float tolerance (the JAX package's claim,
    ``tests/test_slabs.py::test_banded_sweep_matches_single_pass``)."""
    bricks, scalars = scene
    _, _, cam, fs = _case(eye)
    grids = P.build_level_grids(bricks, scalars, axis=2, device="cpu")
    extent = float(grids.bounds_hi[0] - grids.bounds_lo[0])
    ns = 4 * -(-int(np.ceil(extent / 0.4)) // 4)
    cfg = P.SlabConfig(num_channels=1, nslabs=ns)
    single = P.render_slabs_camera(grids, fs, cfg, cam, SIZE, SIZE).numpy()
    banded = P.render_slabs_banded(bricks, scalars, fs, cfg, cam, SIZE,
                                   SIZE, n_bands=4, reuse=False,
                                   device="cpu").numpy()
    np.testing.assert_allclose(banded, single, atol=2e-5)
    assert single[:, 3].max() > 0.1
    # the collapse is deferred to the combiner: a band renders without it
    nc = P.render_slabs_camera(
        grids, fs, dataclasses.replace(cfg, saturate_collapse=False), cam,
        SIZE, SIZE).numpy()
    sat = single[:, 3] == 1.0
    assert sat.any() and (nc[sat, 3] < 1.0).all()


def test_banded_peak_memory_bounded():
    """Four separated 8^3 blocks along z: a band's grids on the device
    are a fraction of the full grids, and ``full_bytes`` is what
    ``build_level_grids`` holds for the whole scene."""
    text = "".join(f"0 0 {16 * k} 8 8 8 0 {0.1 * (k + 1):.2f}\n"
                   for k in range(4))
    lower, level, scal = parse_grids_text(text)
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    scalars = np.asarray(sc.scalars)
    cam = Camera.look_at([4.0, 4.0, 90.0], [4.0, 4.0, 28.0], [0, 1, 0], 40.0,
                         8, 8)
    fs = interop.frame_state_from_reference(make_frame_state(
        cam, 1, [[0.0, 1.0]], dt=0.5, opacity_scale=0.5))
    mem = {}
    out = P.render_slabs_banded(bricks, scalars, fs,
                                P.SlabConfig(num_channels=1, nslabs=64,
                                             chunk=8),
                                cam, 8, 8, n_bands=8, mem_stats=mem,
                                reuse=False, device="cpu")
    full = P.nbytes_grids(P.build_level_grids(bricks, scalars, axis=2,
                                              device="cpu"))
    assert mem["full_bytes"] == full
    assert 0 < mem["peak_band_bytes"] <= full * 0.5, (mem, full)
    assert out[:, 3].max() > 0.1


def test_banded_reuse_cache(scene):
    """With ``reuse`` the host band grids are built once and kept: the
    second frame finds the same cache entry and renders the same image;
    ``reuse=False`` leaves the cache alone."""
    bricks, scalars = scene
    _, _, cam, fs = _case([6.0, 2.0, 30.0], at=(6.0, 2.0, 2.0))
    cfg = P.SlabConfig(num_channels=1, nslabs=24)
    P._BAND_GRID_CACHE.clear()
    a = P.render_slabs_banded(bricks, scalars, fs, cfg, cam, 16, 16,
                              n_bands=3, device="cpu")
    assert len(P._BAND_GRID_CACHE) == 1
    key, (pin, _, bands) = next(iter(P._BAND_GRID_CACHE.items()))
    assert pin is bricks.lower
    assert sum(v is not None for v in bands.values()) >= 2
    assert all(v is None or v.device.type == "cpu" for v in bands.values())
    b = P.render_slabs_banded(bricks, scalars, fs, cfg, cam, 16, 16,
                              n_bands=3, device="cpu")
    assert P._BAND_GRID_CACHE[key][2] is bands
    assert torch.equal(a, b)
    P._BAND_GRID_CACHE.clear()
    P.render_slabs_banded(bricks, scalars, fs, cfg, cam, 16, 16, n_bands=3,
                          reuse=False, device="cpu")
    assert not P._BAND_GRID_CACHE


def test_banded_carry_matches_single_pass_when_saturated():
    """A 16^3 block filling the view at a high opacity: every pixel
    saturates in the front band.  Each band continues the composite of
    the bands in front, so the early exit and the saturation skips act
    as in one pass and the banded frame equals the single pass; the JAX
    package's band merge (each band composited from zero) takes in the
    light behind the saturated tiles."""
    lower, level, scal = parse_grids_text(
        "0 0 0 16 16 16 0 0 1 2 3 4 5 6 7\n")
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    scalars = np.asarray(sc.scalars)
    args = ([8.0, 8.0, 24.0], [8.0, 8.0, 8.0], [0, 1, 0], 30.0, 24, 16)
    jfs = make_frame_state(JCamera.look_at(*args), 1, [[0.0, 7.0]], dt=1.0,
                           opacity_scale=3.0)
    cam, fs = Camera.look_at(*args), interop.frame_state_from_reference(jfs)
    cfg = P.SlabConfig(nslabs=36)
    single = P.render_slabs_camera(P.build_level_grids(
        bricks, scalars, device="cpu"), fs, cfg, cam, 24, 16).numpy()
    banded = P.render_slabs_banded(bricks, scalars, fs, cfg, cam, 24, 16,
                                   n_bands=3, reuse=False,
                                   device="cpu").numpy()
    assert single[:, 3].min() == 1.0
    np.testing.assert_allclose(banded, single, atol=1e-6)
    ref = np.asarray(R.render_slabs_banded(
        bricks, scalars, jfs, R.SlabConfig(nslabs=36),
        JCamera.look_at(*args), 24, 16, n_bands=3, reuse=False))
    assert np.abs(ref - single).max() > 1e-5
    _gate(banded, ref)

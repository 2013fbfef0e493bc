"""PyTorch port, the multi-device modes (``owlexabrick_tpu_torch.parallel.
mesh``) over ``torch.distributed`` against the JAX package's meshes on
the same inputs: four gloo ranks on the CPU (spawned once with
``torch.multiprocessing``; the rank bodies are
``tests/torch_mesh_ranks.py``) run a 2x2 px/spp mesh of the exact path,
pixel-band meshes (4x1 and 2x2, jittered) of the slab fast path and 2-
and 4-band z meshes (the first two ranks for 2 bands), the sweep towards
+z and -z (``flip``), on ``__graft_entry__.py``'s tiny scene (EX4) and
EX2 / EX3.  Each mesh's image is held to the same work done in one
process (the module's ``*_reference``: the per-tile, per-spp loop; the
bands swept in turn) at the dry run's tolerances
(``__graft_entry__.py``: rtol 1e-5 with atol 1e-6, and 1e-4 with 2e-5
for the z bands), and to the JAX package's ``make_sharded_renderer``,
``make_sharded_slab_renderer`` and ``make_band_sharded_slab_renderer``
on the 8 host devices of ``tests/conftest.py``: the exact path at the
dry run's tolerance, the slab modes under the gate that holds the
port's ``render_slabs`` to the JAX one (``tests/test_torch_slabs.py::
_gate``: 2e-4 on 99.5% of pixels, 2e-2 on every pixel; the two
packages' slab frames differ in the last bits of their z, x and y
lerps).  Every rank of a mesh returns the same whole image.
``build_band_grids``'s stacked arrays and meta equal the JAX package's
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.builder.bricker import build_bricks
from owlexabrick_tpu.core.types import ScalarField
from owlexabrick_tpu.parallel import mesh as JM
from owlexabrick_tpu.pipeline import bricks_from_build
from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.dvr import RenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.scene import gather_scalars, to_device
from owlexabrick_tpu.render.slabs import (SlabConfig, build_level_grids,
                                          permute_camera)
from owlexabrick_tpu.render.surfaces import SurfaceData
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.parallel import mesh as PM
from owlexabrick_tpu_torch.render import dvr as PD
from owlexabrick_tpu_torch.render import prng
from owlexabrick_tpu_torch.render import slabs as PS
from owlexabrick_tpu_torch.render.surfaces import SurfaceData as PSurf

from conftest import EX2, EX3, EX4
from test_torch_slabs import _gate
from torch_mesh_ranks import one_process
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
TEXTS = {"graft": EX4, "EX2": EX2, "EX3": EX3}

# name: (mode, scene, mesh shape, key seed or flip)
PX = {"px_graft": ("graft", 2, 2, 0), "px_EX3": ("EX3", 2, 2, 7)}
BANDS = {"bands4_graft": ("graft", 4, 1, 1), "bands2x2_EX2": ("EX2", 2, 2, 3)}
ZBANDS = {"z2_EX3": ("EX3", 2, False), "z4_EX3_flip": ("EX3", 4, True),
          "z4_graft": ("graft", 4, False), "z2_graft_flip": ("graft", 2, True)}


def _cells(name):
    lower, level, scal = parse_grids_text(TEXTS[name])
    bricks, ids = bricks_from_build(build_bricks(lower, level))
    scalars = gather_scalars(ids, [ScalarField.from_values("f", scal)])
    return lower, level, scal, bricks, scalars


def _exact_case(name):
    """The dry run's exact-path frame: its camera at 8 * n_px x 8."""
    scene_name, n_px, n_spp, seed = PX[name]
    lower, level, scal, *_ = _cells(scene_name)
    scene, *_ = scene_from_cells(lower, level, [scal])
    w, h = 8 * n_px, 8
    cam = Camera.look_at(from_=[14.0, 10.0, 16.0], at=[4.0, 2.0, 2.0],
                         up=[0, 1, 0], fovy_degrees=50.0, width=w, height=h)
    fs = make_frame_state(cam, 1, [[0.0, 2.0 if scene_name == "graft"
                                    else 7.0]], dt=0.7)
    o, d = cam.rays(w, h)
    return scene, fs, o, d, RenderConfig(num_channels=1), seed


def _slab_case(scene_name, sh, flip):
    """The dry run's slab frame: a 16 x sh camera down z (up z when
    ``flip``), 32 slabs, chunk 8."""
    *_, bricks, scalars = _cells(scene_name)
    grids = build_level_grids(bricks, scalars, axis=2)
    zc = 30.0 if flip else -26.0
    cam = Camera.look_at([4.0, 2.0, zc], [4.0, 2.0, 2.0], [0, 1, 0], 40.0,
                         16, sh)
    fs = make_frame_state(cam, 1, [[0.0, 2.0 if scene_name == "graft"
                                    else 7.0]], dt=0.7)
    cam_v = permute_camera(cam, 2)
    assert bool(cam_v[1][0] < 0) == flip
    cfg = SlabConfig(nslabs=32, chunk=8, flip=flip)
    return bricks, scalars, grids, fs, cam_v, cfg


def _pcfg(cfg):
    return PS.SlabConfig(nslabs=cfg.nslabs, chunk=cfg.chunk, flip=cfg.flip)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's port inputs, run once by four spawned gloo ranks;
    returns the directory of their images."""
    import torch.multiprocessing as mp

    from torch_mesh_ranks import free_port, run

    d = tmp_path_factory.mktemp("mesh")
    cases = {}
    for name in PX:
        scene, fs, o, d_, cfg, seed = _exact_case(name)
        _, n_px, n_spp, _ = PX[name]
        cases[name] = dict(
            mode="px", n_px=n_px, n_spp=n_spp, device="cpu",
            scene=interop.scene_from_reference(scene, "cpu"),
            fs=interop.frame_state_from_reference(fs),
            surf=PSurf.empty("cpu"), o=o, d=d_, key=prng.prng_key(seed),
            cfg=PD.RenderConfig(**dataclasses.asdict(cfg)))
    for name, (scene_name, n_px, n_spp, seed) in BANDS.items():
        _, _, grids, fs, cam_v, cfg = _slab_case(scene_name, 8 * n_px, True)
        cases[name] = dict(
            mode="pixel_bands", n_px=n_px, n_spp=n_spp, device="cpu",
            grids=interop.level_grids_from_reference(grids, "cpu"),
            fs=interop.frame_state_from_reference(fs), camera=cam_v,
            key=prng.prng_key(seed), cfg=_pcfg(cfg), w=16, h=8 * n_px,
            jitter=True)
    for name, (scene_name, n_bands, flip) in ZBANDS.items():
        bricks, scalars, _, fs, cam_v, cfg = _slab_case(scene_name, 16, flip)
        cases[name] = dict(
            mode="z", n_bands=n_bands, device="cpu",
            bricks={k: np.asarray(getattr(bricks, k))
                    for k in ("lower", "size", "level", "begin")},
            scalars=np.asarray(scalars),
            fs=interop.frame_state_from_reference(fs), camera=cam_v,
            cfg=_pcfg(cfg), w=16, h=16)
    torch.save(cases, d / "cases.pt")
    mp.start_processes(run, args=(WORLD, free_port(), str(d / "cases.pt"),
                                  str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return d


def _port_case(ranks, name):
    return torch.load(ranks / "cases.pt", weights_only=False)[name]


def _rank_images(ranks, name, n):
    """The n ranks' images, each equal to rank 0's; no file from the
    ranks outside the mesh."""
    imgs = [np.load(ranks / f"{name}_r{r}.npy") for r in range(n)]
    for im in imgs[1:]:
        assert np.array_equal(im, imgs[0])
    assert not (ranks / f"{name}_r{n}.npy").exists()
    assert np.isfinite(imgs[0]).all()
    return imgs[0]


@pytest.mark.parametrize("name", list(PX))
def test_px_spp_mesh_matches_jax(ranks, name):
    scene, fs, o, d, cfg, seed = _exact_case(name)
    _, n_px, n_spp, _ = PX[name]
    mesh = JM.make_mesh(n_px, n_spp)
    f = JM.make_sharded_renderer(mesh, cfg)
    want = np.asarray(f(
        JM.replicate(mesh, to_device(scene)), JM.replicate(mesh, fs),
        JM.replicate(mesh, SurfaceData.empty()), *JM.shard_rays(mesh, o, d),
        jax.random.PRNGKey(seed)))
    got = _rank_images(ranks, name, n_px * n_spp)
    assert got.shape == (o.shape[0], 3)
    one = one_process(_port_case(ranks, name))
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.max() > 0.05


@pytest.mark.parametrize("name", list(BANDS))
def test_pixel_band_mesh_matches_jax(ranks, name):
    scene_name, n_px, n_spp, seed = BANDS[name]
    _, _, grids, fs, cam_v, cfg = _slab_case(scene_name, 8 * n_px, True)
    mesh = JM.make_mesh(n_px, n_spp)
    f = JM.make_sharded_slab_renderer(mesh, cfg, 16, 8 * n_px, jitter=True)
    want = np.asarray(f(JM.replicate(mesh, grids),
                        jax.tree.map(jnp.asarray, fs),
                        *(jnp.asarray(v) for v in cam_v),
                        jax.random.PRNGKey(seed)))
    got = _rank_images(ranks, name, n_px * n_spp)
    assert got.shape == (16 * 8 * n_px, 4)
    one = one_process(_port_case(ranks, name))
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-6)
    _gate(got, want, 2e-4)
    assert want[:, 3].max() > 0.1


@pytest.mark.parametrize("name", list(ZBANDS))
def test_z_band_mesh_matches_jax(ranks, name):
    scene_name, n_bands, flip = ZBANDS[name]
    bricks, scalars, _, fs, cam_v, cfg = _slab_case(scene_name, 16, flip)
    stacked, meta = JM.build_band_grids(bricks, scalars, n_bands,
                                        cfg.nslabs, axis=2)
    mesh = JM.make_band_mesh(n_bands)
    f = JM.make_band_sharded_slab_renderer(mesh, cfg, meta, 16, 16)
    want = np.asarray(f(JM.shard_bands(mesh, stacked),
                        jax.tree.map(jnp.asarray, fs),
                        *(jnp.asarray(v) for v in cam_v)))
    got = _rank_images(ranks, name, n_bands)
    assert got.shape == (256, 4)
    one = one_process(_port_case(ranks, name))
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-4, atol=2e-5)
    _gate(got, want, 2e-4)
    assert want[:, 3].max() > 0.1


@pytest.mark.parametrize("n_bands", [2, 3, 4])
@pytest.mark.parametrize("scene_name", ["graft", "EX3"])
def test_build_band_grids_equal(scene_name, n_bands):
    *_, bricks, scalars = _cells(scene_name)
    want, want_meta = JM.build_band_grids(bricks, scalars, n_bands, 32,
                                          axis=2)
    got, got_meta = PM.build_band_grids(bricks, scalars, n_bands, 32,
                                        axis=2)
    assert got_meta == want_meta
    assert set(got) == set(want)
    for k in want:
        w = want[k] if isinstance(want[k], list) else [want[k]]
        g = got[k] if isinstance(got[k], list) else [got[k]]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert isinstance(a, np.ndarray)
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b)), k

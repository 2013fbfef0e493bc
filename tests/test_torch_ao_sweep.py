"""PyTorch port, the lattice AO estimator (``render/ao_sweep.py``) and the
random draws it takes (``render/prng.py``) against the JAX package's: the
port's ``uniform`` of shapes (P,) and (P, 2) and ``normal`` of (4, 3)
equal ``jax.random``'s bit for bit; the axis-2 level grids the lattice is
built from equal the JAX package's ``grids_from_scene`` array for array;
``build_ao_lattice``, ``iso_indicator`` and ``shadow_volume`` are equal;
``ao_shadow_fast`` is within 1e-6, with and without a geometric
occluder."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import ao_sweep as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.slabs import grids_from_scene
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render import ao_sweep as P
from owlexabrick_tpu_torch.render import prng
from owlexabrick_tpu_torch.render.slabs import level_grids_from_cells
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

N = 32


@pytest.fixture(scope="module")
def grids():
    """The golden scene's axis-2 level grids in both packages."""
    lower, level, scal = volume_to_cells(synthetic_volume(N), 0.004, 3)
    scene, *_ = scene_from_cells(lower, level, [scal])
    ref = grids_from_scene(scene, axis=2, device=False)
    port = level_grids_from_cells(lower, level, scal, axis=2, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def lattices(grids):
    ref, port = grids
    return R.build_ao_lattice(ref), P.build_ao_lattice(port)


@pytest.fixture(scope="module")
def frame_state():
    cam = RefCamera.look_at([N / 2, N / 2, N * 2.1], [N / 2] * 3, [0, 1, 0],
                            45.0, 96, 64)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], ao_enabled=True,
                          ao_length=N * 0.5)
    return dataclasses.replace(
        fs, iso_enabled=np.asarray([True, True]),
        iso_value=np.asarray([0.55, 0.3], np.float32))


def _keys(frame, fold):
    ref = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0x51AB), frame), fold)
    port = prng.fold_in(prng.fold_in(prng.prng_key(0x51AB), frame), fold)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(ref))) \
        == port
    return ref, port


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("frame", [0, 1, 5, 63])
def test_draws_bit_equal_jax(frame):
    """uniform (P,), uniform (P, 2) and normal (4, 3) from the keys the
    Renderer folds (surface pass 3, AO 7, the pool 101, per sample s)."""
    for fold in (3, 7):
        ref, port = _keys(frame, fold)
        for s in (0, 1):
            kr, kp = jax.random.fold_in(ref, s), prng.fold_in(port, s)
            for shape in ((6144,), (6144, 2), (777,)):
                np.testing.assert_array_equal(
                    _bits(prng.uniform(kp, shape, "cpu").numpy()),
                    _bits(jax.random.uniform(kr, shape)))
        kr, kp = jax.random.fold_in(ref, 101), prng.fold_in(port, 101)
        np.testing.assert_array_equal(_bits(prng.normal(kp, (4, 3))),
                                      _bits(jax.random.normal(kr, (4, 3))))


def test_normal_bit_equal_jax_many_keys():
    """normal over 64 keys x 96 draws: every draw's bits (XLA's erf_inv,
    log1p and log on the host)."""
    for frame in range(64):
        kr, kp = _keys(frame, 101)
        np.testing.assert_array_equal(_bits(prng.normal(kp, (32, 3))),
                                      _bits(jax.random.normal(kr, (32, 3))))


def test_level_grids_equal_grids_from_scene(grids):
    """The port's axis-2 level grids from cells equal the JAX package's
    grids_from_scene (the AO lattice's input) array for array."""
    ref, port = grids
    assert port.levels == tuple(int(l) for l in ref.levels)
    assert port.axis == ref.axis == 2
    for a, b in zip(port.vals, ref.vals):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(port.masks, ref.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(port.origins, ref.origins):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    np.testing.assert_array_equal(port.bounds_lo, np.asarray(ref.bounds_lo))
    np.testing.assert_array_equal(port.bounds_hi, np.asarray(ref.bounds_hi))


def test_build_ao_lattice_equal(lattices):
    (rv, ro, rl, rc), (pv, po, pl, pc) = lattices
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_array_equal(pl, rl)
    assert pc == rc
    assert po.any() and (pv > 0.55).any()


def test_iso_indicator_and_shadow_volume_equal(lattices, frame_state):
    (rv, ro, _, _), (pv, po, _, _) = lattices
    fs = interop.frame_state_from_reference(frame_state)
    ind_r = R.iso_indicator(jnp.asarray(rv), jnp.asarray(ro), frame_state)
    ind_p = P.iso_indicator(torch.from_numpy(pv), torch.from_numpy(po), fs)
    np.testing.assert_array_equal(ind_p.numpy(), np.asarray(ind_r))
    assert 0 < float(ind_p.mean()) < 0.5
    max_len = max(rv.shape)
    u = np.random.default_rng(7).normal(size=(6, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    for d, cells in zip(u, (1.0, 3.0, 7.5, 16.0, 40.0, 2.0)):
        want = R.shadow_volume(ind_r, jnp.asarray(d), jnp.float32(cells),
                               max_len)
        got = P.shadow_volume(ind_p, d, np.float32(cells), max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.sum()) >= float(ind_p.sum())


@pytest.mark.parametrize("geom", [False, True], ids=["iso", "iso+geom"])
@pytest.mark.parametrize("frame", [0, 3])
def test_ao_shadow_fast_matches_jax(lattices, frame_state, geom, frame):
    """The per-pixel estimator on 4096 seeded hits and normals, 2 samples
    of a 4-direction pool, optionally OR-ed with a geometric occluder (a
    fixed function of the per-pixel direction): within 1e-6."""
    lat_r, lat_p = lattices
    rng = np.random.default_rng(frame)
    hits = rng.uniform(2.0, N - 2.0, (4096, 3)).astype(np.float32)
    nrm = rng.normal(size=(4096, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    kr, kp = _keys(frame, 7)
    occ_r = occ_p = None
    if geom:
        def occ_r(d):
            return (d[:, 0] > 0.2).astype(jnp.float32)

        def occ_p(d):
            return (d[:, 0] > 0.2).to(torch.float32)
    want = R.ao_shadow_fast(
        (jnp.asarray(lat_r[0]), jnp.asarray(lat_r[1]),
         jnp.asarray(lat_r[2]), lat_r[3]), frame_state, jnp.asarray(hits),
        jnp.asarray(nrm), kr, ao_samples=2, geom_occluder=occ_r, ao_dirs=4)
    got = P.ao_shadow_fast(
        P.lattice_to(lat_p, "cpu"),
        interop.frame_state_from_reference(frame_state),
        torch.from_numpy(hits), torch.from_numpy(nrm), kp, ao_samples=2,
        geom_occluder=occ_p, ao_dirs=4)
    want = np.asarray(want)
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

"""PyTorch port, the packed exact march (``render/wavefront.py``) against
the JAX package's on the CPU, on EX2-EX4 built by each package's own
``scene_from_cells`` and level grids: ``build_pack``'s node table, start
grid, descent and grid geometry equal (also on a coarse start grid whose
descent is not 0); ``locate_packed`` equal to the JAX function on the
JAX tables (``interop.pack_from_reference``) and to the port's
``locate_leaf``; ``sample_packed`` within rtol 2e-5 / atol 2e-6 of the
JAX values (one and two channels); ``trace_dvr_packed`` within the JAX
package's own packed-against-classic bound (rtol 1e-4, atol 1e-5) on
tests/test_wavefront_packed.py's three cameras; the compacted entry
point equal to ``trace_dvr_packed`` bit for bit; ``render_step_packed``
against JAX's at 24x24 under the slab gate; the refusals; and the
region walk's locator: the default BSP descent equal bit for bit to the
lockstep march, and the packed locator under the classic sampler equal
to ``trace_dvr`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render import renderer as RR
from owlexabrick_tpu.render import wavefront as RW
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.dvr import RenderConfig as RefConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.scene import to_device
from owlexabrick_tpu.render.slabs import build_level_grids as ref_grids
from owlexabrick_tpu.render.surfaces import SurfaceData as RefSurfaces
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.pipeline import scene_from_cells
from owlexabrick_tpu_torch.render import dvr as P
from owlexabrick_tpu_torch.render import renderer as PR
from owlexabrick_tpu_torch.render import wavefront as PW
from owlexabrick_tpu_torch.render.scene import scene_bricks
from owlexabrick_tpu_torch.render.slabs import build_level_grids
from owlexabrick_tpu_torch.render.surfaces import SurfaceData

from conftest import EX2, EX3, EX4
from test_torch_banded import _gate
from test_torch_dvr import _lockstep
from torch_threads import one_torch_thread  # noqa: F401

TEXTS = {"EX2": EX2, "EX3": EX3, "EX4": EX4}
# tests/test_wavefront_packed.py's cameras (EX3's oblique)
CAMERAS = {"EX2": [4.0, 4.0, 30.0], "EX3": [20.0, 12.0, 25.0],
           "EX4": [-8.0, 3.0, 11.0]}
# a start grid of at most 64 macro cells: wide cells, a non-zero descent
COARSE = 64
SIZE = 24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _packs(name, channels=1, max_grid_cells=1 << 23):
    """An EX fixture's scene, level grids and pack built by each package
    from the cells ((JAX scene, grids, pack), (port scene, pack)), and
    the JAX pack as the port's (``pack_from_reference``)."""
    lower, level, scal = parse_grids_text(TEXTS[name])
    fields = [scal * (c + 1.0) for c in range(channels)]
    ref, bricks, *_ = ref_scene_from_cells(lower, level, fields)
    ref_g = ref_grids(bricks, ref.scalars, axis=2)
    ref_pack = RW.build_pack(to_device(ref), ref_g,
                             max_grid_cells=max_grid_cells)
    port = scene_from_cells(lower, level, fields, device="cpu")[0]
    grids = build_level_grids(*scene_bricks(port), axis=2, device="cpu")
    pack = PW.build_pack(port, grids, max_grid_cells=max_grid_cells)
    return ((ref, ref_g, ref_pack), (port, pack),
            interop.pack_from_reference(ref_pack, ref_g, "cpu"))


def _points(ref, seed, pad):
    lo = np.asarray(ref.region_lo).min(0)
    hi = np.asarray(ref.region_hi).max(0)
    return np.random.default_rng(seed).uniform(
        lo - pad, hi + pad, (512, 3)).astype(np.float32)


@pytest.mark.parametrize("coarse", [False, True], ids=["half_cell", "coarse"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_build_pack_equals_jax(name, coarse):
    """The node table, the start grid and its geometry bit for bit (the
    coarse grid's cells straddle faces: its descent is 6); the
    pack's grids are views into its flat buffer, equal to the JAX
    grids."""
    (_, ref_g, ref_pack), (_, pack), _ = _packs(
        name, max_grid_cells=COARSE if coarse else 1 << 23)
    assert np.array_equal(np.asarray(ref_pack.node_pack),
                          pack.node_pack.numpy())
    assert np.array_equal(np.asarray(ref_pack.start_grid),
                          pack.start_grid.numpy())
    for k in ("descent", "grid_org", "grid_cw", "grid_dims",
              "num_channels"):
        assert getattr(pack, k) == getattr(ref_pack, k), k
    # EX2 is one region, its BSP a single leaf
    assert (pack.descent > 0) == (coarse and name != "EX2")
    flat = pack.flat.untyped_storage().data_ptr()
    for li in range(len(ref_g.levels)):
        for a, b in ((pack.grids.vals[li], ref_g.vals[li]),
                     (pack.grids.masks[li], ref_g.masks[li])):
            assert a.untyped_storage().data_ptr() == flat
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("coarse", [False, True], ids=["half_cell", "coarse"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_locate_packed_equals_jax_and_locate_leaf(name, coarse):
    """Region id and box exactly the JAX function's on the JAX tables,
    and the BSP descent's, on 512 seeded points in and around the
    domain."""
    (ref, _, ref_pack), (port, _), from_ref = _packs(
        name, max_grid_cells=COARSE if coarse else 1 << 23)
    pts = _points(ref, 0, 0.4)
    want = RW.locate_packed(ref_pack, jnp.asarray(pts))
    got = PW.locate_packed(from_ref, _t(pts))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    node = P.locate_leaf(port, _t(pts))
    for a, b in zip(got, (port.tree_leaf, port.tree_lo, port.tree_hi)):
        assert torch.equal(a, b[node])


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", list(TEXTS))
def test_sample_packed_matches_jax(name, channels):
    """``ok`` equal and each channel's value within rtol 2e-5 / atol
    2e-6 of the JAX ``sample_packed`` on 512 seeded points."""
    (ref, _, ref_pack), (_, pack), _ = _packs(name, channels)
    pts = _points(ref, 1, 0.4)
    for c in range(channels):
        ok_w, v_w = (np.asarray(a) for a in RW.sample_packed(
            ref_pack, jnp.asarray(pts), c))
        ok, v = (a.numpy() for a in PW.sample_packed(pack, _t(pts), c))
        assert np.array_equal(ok, ok_w) and 0.3 < ok.mean() < 1.0
        np.testing.assert_allclose(v[ok], v_w[ok], rtol=2e-5, atol=2e-6)


def _frame(name, size=SIZE):
    cam = Camera.look_at(CAMERAS[name], [4.0, 2.0, 2.0], [0, 1, 0], 45.0,
                         size, size)
    fs = make_frame_state(cam, 1, [[0.0, 7.0]], dt=0.3, opacity_scale=0.6)
    o, d = cam.rays(size, size)
    offset = np.random.default_rng(3).random(size * size).astype(np.float32)
    return fs, o, d, offset


@pytest.mark.parametrize("name", list(TEXTS))
def test_trace_dvr_packed_matches_jax(name):
    """The packed march within rtol 1e-4 / atol 1e-5 of the JAX one (the
    JAX package's own bound for packed against classic), and the
    compacted entry point equal to it bit for bit."""
    (ref, _, ref_pack), (port, pack), _ = _packs(name)
    fs, o, d, offset = _frame(name)
    want = np.asarray(jax.jit(RW.trace_dvr_packed, static_argnames="cfg")(
        ref_pack, to_device(ref), jax.tree.map(jnp.asarray, fs),
        RefConfig(num_channels=1), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(offset)))
    pfs = interop.frame_state_from_reference(fs)
    args = (pack, port, pfs, P.RenderConfig(), _t(o), _t(d), _t(offset))
    got = PW.trace_dvr_packed(*args)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, PW.trace_dvr_packed_compacted(
        *args, round_iters=2, min_size=16))
    assert torch.equal(got, PW.trace_dvr_packed(*args, batch=97))


def test_render_step_packed_matches_jax():
    """One progressive frame through ``render_step_packed`` at 24x24
    against the JAX function's (same jitter keys, surface pass, clip
    box): the display colors under the slab gate, the accumulation
    buffers within 1e-4, and the frame against the port's classic
    ``render_step`` under the same gate."""
    (ref, _, ref_pack), (port, pack), _ = _packs("EX3")
    fs, *_ = _frame("EX3")
    ref_out = RR.render_step_packed(
        ref_pack, to_device(ref), jax.tree.map(jnp.asarray, fs),
        RefSurfaces.empty(), jnp.zeros((SIZE * SIZE, 4)),
        cfg=RefConfig(num_channels=1), width=SIZE, height=SIZE)
    pfs = interop.frame_state_from_reference(fs)
    accum = torch.zeros((SIZE * SIZE, 4))
    kw = dict(cfg=P.RenderConfig(), width=SIZE, height=SIZE)
    got = PR.render_step_packed(pack, port, pfs, SurfaceData.empty("cpu"),
                                accum, **kw)
    want = [np.asarray(a) for a in ref_out]
    assert (want[2] > 0.05).any()
    _gate(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-4)
    classic = PR.render_step(port, pfs, SurfaceData.empty("cpu"), accum,
                             **kw)
    _gate(got[2].numpy(), classic[2].numpy())


@pytest.mark.parametrize("field", ["gradient_shading_dvr", "nearest"])
@pytest.mark.parametrize("entry", ["trace_dvr_packed",
                                   "trace_dvr_packed_compacted"])
def test_packed_refuses_other_configs(entry, field):
    """Gradient shading and nearest-cell sampling need the classic
    sampler: both entry points raise, as the JAX package's do."""
    _, (port, pack), _ = _packs("EX2")
    fs, o, d, offset = _frame("EX2", 4)
    cfg = (P.RenderConfig(gradient_shading_dvr=True)
           if field == "gradient_shading_dvr"
           else P.RenderConfig(basis_method=False))
    with pytest.raises(ValueError, match="use trace_dvr"):
        getattr(PW, entry)(pack, port, interop.frame_state_from_reference(fs),
                           cfg, _t(o), _t(d), _t(offset))


@pytest.mark.parametrize("name", ["EX3", "EX4"])
def test_region_walk_locators(name):
    """The walk's default locator (the BSP descent) gives the lockstep
    march's rgba bit for bit, as before the walk took a locator; the
    packed locator (its ids and boxes are the descent's) under the
    classic sampler gives ``trace_dvr``'s rgba bit for bit."""
    _, (port, pack), _ = _packs(name)
    fs, o, d, offset = _frame(name)
    pfs = interop.frame_state_from_reference(fs)
    cfg = P.RenderConfig()
    want = P.trace_dvr(port, pfs, cfg, _t(o), _t(d), _t(offset))
    lock, _ = _lockstep(port, pfs, cfg, _t(o), _t(d), _t(offset))
    assert torch.equal(want, lock) and float(want[:, 3].max()) > 0.5

    rays, off, xf, act = P.dvr_setup(port, pfs, cfg, _t(o), _t(d),
                                     _t(offset))

    def sample(rid, d_l, fcw, pos, _t_s, actual_dt, st):
        return P._march_step(port, xf, cfg, act, rid, d_l, fcw, pos,
                             actual_dt, st)

    (got,), _ = P.march_batches(
        port, xf, rays, off, act, cfg.max_region_iters,
        [torch.zeros((off.shape[0], 4))], sample, P._dvr_region_done,
        1 << 14, locate=lambda p: PW.locate_packed(pack, p))
    assert torch.equal(got, want)

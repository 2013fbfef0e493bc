"""PyTorch port, the exact DVR core against the JAX package's on the CPU:
``locate_leaf`` equal; ``sample_basis`` (value and gradient),
``sample_nearest`` and ``gradient_cd`` within 1e-6 of the JAX values'
scale (each test states where the quotient's cancellation needs more);
``trace_dvr`` within 1e-5 absolute on rgba of the JAX ``trace_dvr``
(2e-5 with CD shading) and within 5e-3 of the numpy oracle
(tests/test_dvr_golden.py's gate) on EX2-EX4, with space skipping on and
off, CD gradients, nearest mode and ALLOW_EMPTY_CELLS; and the live-ray
march equal bit for bit to the lockstep march it replaces.

The two packages sum a sample's (K, 8) basis terms in different orders
(XLA fuses the reduction into the jitted march), so values differ in
their last bits; a gradient is a difference of such sums, and CD shading
divides by its length."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.bench_scene import synthetic_volume as ref_volume
from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render import dvr as R
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.scene import build_scene as ref_build_scene
from owlexabrick_tpu.render.scene import to_device
from owlexabrick_tpu.core.types import ScalarField as RefField
from owlexabrick_tpu.tools.raw2cells import volume_to_cells as ref_cells
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.core.constants import (
    REGION_ADVANCE_EPS, TERMINATION_THRESHOLD)
from owlexabrick_tpu_torch.oracle import reference as oracle
from owlexabrick_tpu_torch.render import dvr as P

from conftest import EX2, EX3, EX4
from test_empty_cells import _poisoned_scene
from torch_threads import one_torch_thread  # noqa: F401

TEXTS = {"EX2": (EX2, 7.0), "EX3": (EX3, 7.0), "EX4": (EX4, 2.0)}
SIZE = 12


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dtype)


def _fixture_scene(amr_fixture, name, basis=True):
    """A JAX Scene of an EX fixture (non-basis: per-brick leaves) and
    its frame state, rays and a seeded jitter offset
    (tests/test_dvr_golden.py's camera)."""
    text, vmax = TEXTS[name]
    lower, level, scal = amr_fixture(text)
    ref, bricks, ids, *_ = ref_scene_from_cells(lower, level, [scal])
    if not basis:
        ref, *_ = ref_build_scene(bricks, ids, [RefField.from_values(
            "f", np.asarray(scal, np.float32))], basis_method=False)
    cam = Camera.look_at(from_=[12.0, 10.0, 14.0], at=[4.0, 2.0, 2.0],
                         up=[0, 1, 0], fovy_degrees=50.0, width=SIZE,
                         height=SIZE)
    fs = make_frame_state(cam, num_channels=1, xf_domains=[[0.0, vmax]],
                          dt=0.7)
    o, d = cam.rays(SIZE, SIZE)
    offset = np.random.default_rng(7).random(o.shape[0]).astype(np.float32)
    return ref, fs, o, d, offset


@pytest.fixture(scope="module")
def golden():
    """The 32^3 golden scene (JAX), its port, and seeded points inside
    regions."""
    lower, level, scal = ref_cells(ref_volume(32), 0.004, 3)
    ref, *_ = ref_scene_from_cells(lower, level, [scal, 1.05 - scal],
                                   num_range_channels=2)
    port = interop.scene_from_reference(ref, device="cpu")
    pts = np.random.default_rng(1).uniform(-1, 33, (6000, 3)).astype(
        np.float32)
    return ref, port, pts


def _ref_trace(ref, fs, cfg, o, d, offset, **kw):
    f = jax.jit(R.trace_dvr, static_argnames=("cfg", "return_stats"))
    out = f(to_device(ref), fs, cfg, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(offset), **kw)
    return jax.tree.map(np.asarray, out)


def _port_trace(ref, fs, cfg, o, d, offset, **kw):
    out = P.trace_dvr(interop.scene_from_reference(ref, "cpu"),
                      interop.frame_state_from_reference(fs),
                      P.RenderConfig(**dataclasses.asdict(cfg)), _t(o),
                      _t(d), _t(offset), **kw)
    return jax.tree.map(lambda x: x.numpy(), out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def test_locate_leaf_and_active_mask(golden):
    """Point location lands in the same BSP node for every point (inside
    and outside the domain); the TF-culling mask is the JAX one."""
    ref, port, pts = golden
    want = np.asarray(R.locate_leaf(to_device(ref), jnp.asarray(pts)))
    got = P.locate_leaf(port, _t(pts)).numpy()
    assert np.array_equal(want, got)
    fs = make_frame_state(Camera.look_at([0, 0, 90.0], [16, 16, 16],
                                         [0, 1, 0], 40.0, 8, 8), 2,
                          [[0.9, 1.0], [0.9, 1.0]])
    want = np.asarray(R.region_active_mask(to_device(ref), fs, 2))
    got = P.region_active_mask(port, P.XFTensors.from_frame(
        interop.frame_state_from_reference(fs), "cpu"), 2).numpy()
    assert np.array_equal(want, got) and 0 < want.mean() < 1


def test_sample_basis_matches_reference(golden):
    """Value and quotient-rule gradient numerator of both channels at
    points in their regions: ok equal, values and channel 0's gradient
    within 1e-6 of their scale; channel 1 (1.05 - v: the quotient
    numerator sw sd - swv sdc cancels to 1e-2 of its terms) within
    1e-5."""
    ref, port, pts = golden
    rid = np.asarray(ref.tree_leaf)[np.asarray(
        R.locate_leaf(to_device(ref), jnp.asarray(pts)))]
    keep = rid >= 0
    rid, pts = rid[keep], pts[keep]
    f = jax.jit(R.sample_basis, static_argnums=(3, 4))
    for c in (0, 1):
        ok_a, v_a, g_a = f(to_device(ref), jnp.asarray(rid),
                           jnp.asarray(pts), c, True)
        ok_b, v_b, g_b = P.sample_basis(port, _t(rid, torch.int64), _t(pts),
                                        c, True)
        assert np.array_equal(np.asarray(ok_a), ok_b.numpy())
        assert _rel(v_a, v_b) <= 1e-6
        assert _rel(g_a, g_b) <= (1e-6, 1e-5)[c]
        _, v_c = P.sample_basis(port, _t(rid, torch.int64), _t(pts), c)
        assert torch.equal(v_b, v_c)


@pytest.mark.parametrize("fixed", [False, True], ids=["relocate", "fixed"])
def test_gradient_cd_matches_reference(golden, fixed):
    """Central differences with per-offset relocation under a culling
    mask, and with the caller's region kept (FAST_CENTRAL_DIFFERENCES),
    within 1e-6 of the gradient's scale; a kept region's offset point
    outside its bricks' support sums weights near 1e-20 and its value
    to ~100x the field's, so each value is also allowed 5e-4 of
    itself."""
    ref, port, pts = golden
    dref = to_device(ref)
    rid = np.asarray(ref.tree_leaf)[np.asarray(
        R.locate_leaf(dref, jnp.asarray(pts)))]
    keep = rid >= 0
    rid, pts = rid[keep], pts[keep]
    act = np.asarray(ref.region_value_range)[:, 1] > 0.3
    fcw = np.asarray(ref.region_finest_cw)[rid]
    delta = (fcw + 1.0) * 0.5
    want = np.asarray(R.gradient_cd(
        dref, jnp.asarray(pts), 0, jnp.asarray(delta), True,
        jnp.asarray(act), jnp.asarray(rid) if fixed else None))
    got = P.gradient_cd(port, _t(pts), 0, _t(delta), True, _t(act, torch.bool),
                        _t(rid, torch.int64) if fixed else None).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4,
                               atol=1e-6 * np.abs(want).max())
    if not fixed:
        assert _rel(want, got) <= 1e-6


def test_sample_nearest_matches_reference(amr_fixture):
    """Non-basis sampling (one brick per leaf) is a plain fetch: equal."""
    ref, *_ = _fixture_scene(amr_fixture, "EX3", basis=False)
    port = interop.scene_from_reference(ref, "cpu")
    pts = np.random.default_rng(2).uniform(0, 12, (500, 3)).astype(
        np.float32)
    rid = np.clip(np.asarray(ref.tree_leaf)[np.asarray(R.locate_leaf(
        to_device(ref), jnp.asarray(pts)))], 0, None)
    ok_a, v_a = R.sample_nearest(to_device(ref), jnp.asarray(rid),
                                 jnp.asarray(pts), 0)
    ok_b, v_b = P.sample_nearest(port, _t(rid, torch.int64), _t(pts), 0)
    assert np.array_equal(np.asarray(ok_a), ok_b.numpy())
    assert np.array_equal(np.asarray(v_a), v_b.numpy())


CASES = {
    "default": dict(),
    "no_skipping": dict(space_skipping=False),
    "cd_gradients": dict(gradient_shading_dvr=True, analytic_gradients=False),
    "cd_fast": dict(gradient_shading_dvr=True, analytic_gradients=False,
                    fast_central_differences=True),
    "max_iters_4": dict(max_region_iters=4),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(TEXTS))
def test_trace_dvr_matches_reference(amr_fixture, name, case):
    """rgba within 1e-5 absolute of the JAX trace_dvr (the same jitter
    offsets; 2e-5 with CD shading, whose gradient of a flat region is a
    difference of nearly equal samples), and the per-ray
    region-iteration counts equal."""
    ref, fs, o, d, offset = _fixture_scene(amr_fixture, name)
    cfg = R.RenderConfig(num_channels=1, **CASES[case])
    want, it_a = _ref_trace(ref, fs, cfg, o, d, offset, return_stats=True)
    got, it_b = _port_trace(ref, fs, cfg, o, d, offset, return_stats=True)
    assert np.abs(want - got).max() <= (2e-5 if case.startswith("cd")
                                        else 1e-5)
    assert np.array_equal(it_a, it_b)
    assert want[:, 3].max() > 0.1


@pytest.mark.parametrize("name", list(TEXTS))
def test_trace_dvr_analytic_gradient_shading(amr_fixture, name):
    """Analytic gradient shading: the quotient-rule numerator cancels,
    so the shade's ulps grow with it — rgba within 1e-4 of JAX's."""
    ref, fs, o, d, offset = _fixture_scene(amr_fixture, name)
    cfg = R.RenderConfig(num_channels=1, gradient_shading_dvr=True)
    want = _ref_trace(ref, fs, cfg, o, d, offset)
    got = _port_trace(ref, fs, cfg, o, d, offset)
    assert np.abs(want - got).max() <= 1e-4


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "cd"])
def test_trace_dvr_nearest_mode(amr_fixture, grad):
    """EXPLICIT_BASIS_METHOD off: nearest-cell samples over per-brick
    leaves (and CD shading with delta (level + 1) / 2), within 1e-5."""
    ref, fs, o, d, offset = _fixture_scene(amr_fixture, "EX3", basis=False)
    cfg = R.RenderConfig(num_channels=1, basis_method=False,
                         gradient_shading_dvr=grad)
    want = _ref_trace(ref, fs, cfg, o, d, offset)
    got = _port_trace(ref, fs, cfg, o, d, offset)
    assert np.abs(want - got).max() <= 1e-5 and want[:, 3].max() > 0.1


def test_trace_dvr_allow_empty_cells(amr_fixture):
    """ALLOW_EMPTY_CELLS on the poisoned EX2 scene
    (tests/test_empty_cells.py): within 1e-5 of JAX's, and within 5e-3
    of the oracle's poison-skip rays."""
    scene, _, _ = _poisoned_scene(amr_fixture)
    cam = Camera.look_at(from_=[12.0, 10.0, 14.0], at=[4.0, 4.0, 4.0],
                         up=[0, 1, 0], fovy_degrees=50.0, width=10,
                         height=10)
    fs = make_frame_state(cam, 1, [[0.0, 7.0]], dt=0.7)
    o, d = cam.rays(10, 10)
    zero = np.zeros(o.shape[0], np.float32)
    cfg = R.RenderConfig(num_channels=1, allow_empty_cells=True)
    want = _ref_trace(scene, fs, cfg, o, d, zero)
    got = _port_trace(scene, fs, cfg, o, d, zero)
    assert np.abs(want - got).max() <= 1e-5
    port = interop.scene_from_reference(scene, "cpu")
    port_fs = interop.frame_state_from_reference(fs)
    for i in range(o.shape[0]):
        np.testing.assert_allclose(got[i], oracle.trace_dvr_ray(
            port, port_fs, o[i], d[i], num_channels=1,
            allow_empty_cells=True), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", list(TEXTS))
def test_trace_dvr_matches_oracle(amr_fixture, name):
    """tests/test_dvr_golden.py's gate: each ray within 5e-3 of the
    scalar numpy oracle (zero jitter offset)."""
    ref, fs, o, d, _ = _fixture_scene(amr_fixture, name)
    got = _port_trace(ref, fs, R.RenderConfig(num_channels=1), o, d,
                      np.zeros(o.shape[0], np.float32))
    port = interop.scene_from_reference(ref, "cpu")
    port_fs = interop.frame_state_from_reference(fs)
    for i in range(o.shape[0]):
        np.testing.assert_allclose(
            got[i], oracle.trace_dvr_ray(port, port_fs, o[i], d[i],
                                         num_channels=1),
            rtol=5e-3, atol=5e-3, err_msg=f"pixel {i}")


def _lockstep(scene, fs, cfg, o_world, d_world, offset):
    """trace_dvr the JAX package's way: every ray steps every region
    iteration and every sample step under masks (no gather)."""
    xf = P.XFTensors.from_frame(fs, "cpu")
    m = scene.voxel_from_world
    o = P._affine_rows(o_world, m, True)
    d = P._affine_rows(d_world, m, False)
    d = d / P._norm3(d)[:, None]
    p = o.shape[0]
    hitb, tb0, tb1 = P.ray_box(o, d, scene.tree_lo[0], scene.tree_hi[0],
                               torch.zeros(p), torch.full((p,), 2e10))
    act = P.region_active_mask(scene, xf, cfg.num_channels)
    eps = torch.clamp(torch.clamp(tb1 - tb0, min=0.0) * 1e-6, min=1e-5)
    limit = torch.minimum(torch.full((p,), 2e10), tb1)
    rgba = torch.zeros((p, 4))
    iters = torch.zeros(p)
    done = ~hitb
    t_cur = torch.clamp(tb0, min=0.0)
    for _ in range(cfg.max_region_iters):
        if bool(done.all()):
            break
        alive = ~done & (t_cur < limit)
        probe = o + torch.minimum(t_cur + eps, limit)[:, None] * d
        node = P.locate_leaf(scene, probe)
        rid = scene.tree_leaf[node]
        hit, t0, t1 = P.ray_box(o, d, scene.tree_lo[node],
                                scene.tree_hi[node], t_cur, limit)
        t1 = torch.where(hit, t1, t_cur + eps)
        rc = torch.clamp(rid, min=0)
        marching = alive & hit & (rid >= 0) & act[rc] & (t1 > t0)
        fcw = scene.region_finest_cw[rc]
        dt = xf.dt * fcw
        t_i = P._sample_grid(dt, t0, offset)
        t_last = t0
        while bool(marching.any()):
            t_next = torch.minimum(t_i, t1)
            t_sample = 0.5 * (torch.minimum(t1, t_next) + t_last)
            (new,), sat = P._march_step(scene, xf, cfg, act, rc, d, fcw,
                                        o + t_sample[:, None] * d,
                                        t_next - t_last, [rgba])
            rgba = torch.where(marching[:, None], new, rgba)
            t_last = t_next
            marching = marching & ~(sat | (t_next >= t1))
            t_i = t_i + dt
        sat = rgba[:, 3] >= TERMINATION_THRESHOLD
        newly = alive & sat & ~done
        rgba = torch.where(newly[:, None], torch.cat(
            [rgba[:, :3] * rgba[:, 3:4], torch.ones(p, 1)], 1), rgba)
        done = done | ~alive | sat
        t_cur = torch.where(alive, t1 * REGION_ADVANCE_EPS, t_cur)
        done = done | (t_cur >= limit)
        iters = iters + alive.float()
    return rgba, iters


@pytest.mark.parametrize("kw", [dict(), dict(gradient_shading_dvr=True),
                                dict(max_region_iters=6)],
                         ids=["default", "gradient", "capped"])
def test_live_ray_march_equals_lockstep(golden, kw):
    """The live-ray march (rays gathered by index, in batches of 97)
    gives the lockstep march's rgba and iteration counts bit for bit on
    a 40x28 view of the 32^3 scene."""
    ref, port, _ = golden
    cam = Camera.look_at([16.0, 14.0, 70.0], [16, 16, 16], [0, 1, 0], 45.0,
                         40, 28)
    fs = interop.frame_state_from_reference(
        make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7))
    o, d = cam.rays(40, 28)
    offset = _t(np.random.default_rng(3).random(o.shape[0]).astype(
        np.float32))
    cfg = P.RenderConfig(num_channels=1, **kw)
    want, it_w = _lockstep(port, fs, cfg, _t(o), _t(d), offset)
    for batch in (None, 97):
        got, it_g = P.trace_dvr(port, fs, cfg, _t(o), _t(d), offset,
                                return_stats=True, batch=batch)
        assert torch.equal(want, got) and torch.equal(it_w, it_g)
    assert float(want[:, 3].max()) > 0.5


def test_generate_rays_matches_reference():
    """Jittered per-pixel rays of the frame-state camera: equal to the
    JAX rays within an ulp."""
    cam = Camera.look_at([40.0, 30.0, 90.0], [16, 16, 16], [0, 1, 0], 45.0,
                         24, 16)
    fs = make_frame_state(cam, 1)
    jit = np.random.default_rng(4).random((24 * 16, 2)).astype(np.float32)
    o_a, d_a = R.generate_rays(fs, 24, 16, jnp.asarray(jit))
    o_b, d_b = P.generate_rays(interop.frame_state_from_reference(fs), 24,
                               16, _t(jit), device="cpu")
    assert np.array_equal(np.asarray(o_a), o_b.numpy())
    np.testing.assert_allclose(d_b.numpy(), np.asarray(d_a), rtol=0,
                               atol=2.4e-7)

"""PyTorch port, surface passes (``owlexabrick_tpu_torch/render/surfaces.py``)
against the JAX package's on seeded inputs: ``SurfaceData.from_meshes``
bit for bit; the dense and tiled triangle and streamline traces; the
port's tiled traces against the JAX package's exact fallback scan; and
``trace_surface_pass`` with its dense geometric AO under the same key.
The port's tiled traces equal its dense ones bit for bit.

Against XLA the hit sets are equal and the triangle normals too (a
gather of the hit triangle's).  XLA fuses the products into multiply-
adds, so t is held to the error float32 can promise for each formula:
triangle t within 4 ulps of the Moller-Trumbore term scale |e1| |e2|
|o - v0| / |det| (an error of 4 ulps in that scale is the dot products'
rounding, whatever their order; both packages come within 2 of a
float64 evaluation on these rays).  Capsule t carries the cancellation
of ba.ba * oa.oa - (ba.oa)^2 over segments far shorter than the ray's
distance: within 1e-4 (relative).  The capsule normals follow the hit
point, so they are held at XLA's t: XLA's normal equals, within 1e-5,
the port's normal at XLA's t on the segment the port hit, or, where the
packages split a near tie (a segment whose t is within that 1e-4), on
the other segment; those ties are counted and stay below 5% of the
hits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.core.types import TriangleMesh as RefTriangleMesh
from owlexabrick_tpu.render import surfaces as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.tracer import morton_order as ref_morton_order
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import bumpy_sphere
from owlexabrick_tpu_torch.render import prng
from owlexabrick_tpu_torch.render import surfaces as P
from owlexabrick_tpu_torch.render.renderer import RenderConfig
from owlexabrick_tpu_torch.render.tracer import morton_order

from test_streamline_tiled import _camera_rays, _tracer_surface

TRI_ULPS = 4
T_RTOL, N_ATOL, TIE_SHARE = 1e-4, 1e-5, 0.05


@pytest.fixture(scope="module")
def meshes():
    """The JAX package's and the port's SurfaceData of two meshes: the
    bumpy sphere (tests/test_streamline_tiled.py::_big_mesh's) and a
    coarser, shifted one."""
    parts = [bumpy_sphere(),
             bumpy_sphere(center=(30.0, 0.0, 0.0), nu=20, nv=12, seed=1)]
    ref = R.SurfaceData.from_meshes(
        [RefTriangleMesh(m.vertices, m.indices) for m in parts])
    port = P.SurfaceData.from_meshes(parts, device="cpu")
    return ref, port


def _rays(w=64, h=48):
    o, d = _camera_rays(w, h)
    p = o.shape[0]
    return (o, d, jnp.full(p, 1e-6, jnp.float32),
            jnp.full(p, 2e10, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _hits(t_ref, t_port):
    """The hit mask of the JAX trace, which the port's must equal."""
    hit = np.isfinite(t_ref) & (t_ref < 1e10)
    assert hit.sum() > 50
    np.testing.assert_array_equal(np.isfinite(t_port) & (t_port < 1e10), hit)
    return hit


def _assert_tri_t(port, o, d, hit, t_ref, t_port):
    """t within TRI_ULPS ulps of each hit's Moller-Trumbore term scale
    (its triangle the port's dense first minimum)."""
    o, d = _t(o)[hit], _t(d)[hit]
    t_all = P._ray_triangles(
        tuple(c[:, None] for c in o.unbind(-1)),
        tuple(c[:, None] for c in d.unbind(-1)),
        *(tuple(c[None] for c in x.unbind(-1))
          for x in (port.tri_v0, port.tri_e1, port.tri_e2)))
    k = t_all.argmin(1)
    v0, e1, e2 = (x[k].double() for x in (port.tri_v0, port.tri_e1,
                                          port.tri_e2))
    det = (torch.cross(d.double(), e2, dim=-1) * e1).sum(-1)
    scale = (e1.norm(dim=-1) * e2.norm(dim=-1)
             * (o.double() - v0).norm(dim=-1) / det.abs()).numpy()
    err = np.abs(t_port[hit].astype(np.float64) - t_ref[hit])
    assert (err <= TRI_ULPS * 2.0 ** -23 * scale).all(), (
        err / (2.0 ** -23 * scale)).max()


def _assert_triangles(port, o, d, t_ref, n_ref, t_port, n_port):
    t_ref, n_ref, t_port, n_port = (np.asarray(x) for x in (
        t_ref, n_ref, t_port, n_port))
    hit = _hits(t_ref, t_port)
    _assert_tri_t(port, o, d, hit, t_ref, t_port)
    np.testing.assert_array_equal(n_port[hit], n_ref[hit])


def _assert_capsules(port, ts, o, d, t0, t1, t_ref, n_ref, t_port, n_port):
    """Hits equal, t within T_RTOL, and XLA's normal within N_ATOL of the
    port's ``_capsule_normal`` at XLA's t on the segment the port hit, or
    on a segment in a near tie (t within T_RTOL), on at most TIE_SHARE
    of the hits."""
    t_ref, n_ref, t_port = (np.asarray(x) for x in (t_ref, n_ref, t_port))
    hit = _hits(t_ref, t_port)
    np.testing.assert_allclose(t_port[hit], t_ref[hit], rtol=T_RTOL)
    o, d, t0, t1 = (_t(x)[hit] for x in (o, d, t0, t1))
    t_all = P._segment_t(tuple(c[:, None] for c in o.unbind(-1)),
                         tuple(c[:, None] for c in d.unbind(-1)),
                         port.seg_a[None], port.seg_b[None],
                         port.seg_t[None], port.seg_radius, ts, t0, t1)
    tr, nr = torch.from_numpy(t_ref[hit]), torch.from_numpy(n_ref[hit])

    def gap(rows, segs):
        n = P._capsule_normal(o[rows], d[rows], tr[rows], port.seg_a[segs],
                              port.seg_b[segs])
        return (n - nr[rows]).abs().amax(-1)

    k = t_all.argmin(1)
    own = gap(torch.arange(tr.shape[0]), k) <= N_ATOL
    rows, segs = ((t_all - tr[:, None]).abs()
                  <= T_RTOL * tr[:, None]).nonzero().unbind(1)
    tie = torch.zeros(tr.shape[0], dtype=torch.int64).index_add_(
        0, rows, (gap(rows, segs) <= N_ATOL).long()) > 0
    print(f"capsule hits {tr.shape[0]}: XLA's normal on the port's segment "
          f"{int(own.sum())}, on a near-tied one {int((~own).sum())}")
    assert bool((own | tie).all())
    assert (~own).float().mean() <= TIE_SHARE
    # the port's normals are that function at its own t, on its segment
    th = torch.from_numpy(t_port[hit])
    assert torch.equal(n_port[torch.from_numpy(hit)], P._capsule_normal(
        o, d, th, port.seg_a[k], port.seg_b[k]))


def test_morton_order_matches_jax():
    pts = np.random.default_rng(3).normal(0, 10, (5000, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(morton_order(pts), ref_morton_order(pts))


def test_from_meshes_bit_equal(meshes):
    ref, port = meshes
    assert port.num_tris == ref.num_tris >= 4096
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n", "seg_a", "seg_b",
              "seg_t"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    assert port.seg_radius == ref.seg_radius
    empty = P.SurfaceData.empty("cpu")
    assert empty.num_tris == empty.num_segments == 0


@pytest.mark.parametrize("lane", ["dense", "tiled"])
def test_triangles_match_jax(meshes, lane):
    """The port's tiled trace equals its dense trace bit for bit."""
    ref, port = meshes
    o, d, t0, t1 = _rays()
    fn = dict(dense=(R.trace_triangles, P.trace_triangles),
              tiled=(R.trace_triangles_tiled, P.trace_triangles_tiled))[lane]
    want = jax.jit(fn[0])(ref, o, d, t0, t1)
    got = fn[1](port, *(_t(x) for x in (o, d, t0, t1)))
    _assert_triangles(port, o, d, *want, *got)
    if lane == "tiled":
        dense = P.trace_triangles(port, *(_t(x) for x in (o, d, t0, t1)))
        for a, b in zip(got, dense):
            assert torch.equal(a, b)


@pytest.mark.parametrize("lane", ["dense", "tiled"])
def test_streamlines_match_jax(lane):
    """Segments past the timestep hidden, dead endpoints in every
    trajectory's tail; the tiled trace equals the dense one bit for
    bit."""
    ref = _tracer_surface(dead_tail=5)
    port = interop.surface_data_from_reference(ref, "cpu")
    o, d, t0, t1 = _rays()
    ts = 30
    fn = dict(dense=(R.trace_streamlines, P.trace_streamlines),
              tiled=(R.trace_streamlines_tiled,
                     P.trace_streamlines_tiled))[lane]
    want = jax.jit(fn[0])(ref, jnp.int32(ts), o, d, t0, t1)
    got = fn[1](port, ts, *(_t(x) for x in (o, d, t0, t1)))
    _assert_capsules(port, ts, o, d, t0, t1, *want, *got)
    if lane == "tiled":
        dense = P.trace_streamlines(port, ts, *(_t(x) for x in (o, d, t0,
                                                                   t1)))
        for a, b in zip(got, dense):
            assert torch.equal(a, b)


@pytest.mark.parametrize("prims", ["triangles", "streamlines"])
def test_tiled_overflow_fallback(meshes, prims):
    """The JAX package's capacity tiers far below the candidate counts,
    so it scans every chunk (its exact fallback): the port's tiled trace,
    which tests every candidate pair whatever their count, matches it,
    and equals the port's dense trace, on screen-tiled blocks."""
    o, d, t0, t1 = _rays()
    args = [_t(x) for x in (o, d, t0, t1)]
    if prims == "triangles":
        ref, port = meshes
        want = jax.jit(lambda *a: R.trace_triangles_tiled(
            *a, max_chunks=(1, 2), screen=(64, 48)))(ref, o, d, t0, t1)
        got = P.trace_triangles_tiled(port, *args, screen=(64, 48))
        dense = P.trace_triangles(port, *args)
        _assert_triangles(port, o, d, *want, *got)
    else:
        ref = _tracer_surface()
        port = interop.surface_data_from_reference(ref, "cpu")
        want = jax.jit(lambda *a: R.trace_streamlines_tiled(
            *a, max_chunks=(1, 2), screen=(64, 48)))(
                ref, jnp.int32(1 << 30), o, d, t0, t1)
        got = P.trace_streamlines_tiled(port, 1 << 30, *args,
                                        screen=(64, 48))
        dense = P.trace_streamlines(port, 1 << 30, *args)
        _assert_capsules(port, 1 << 30, o, d, t0, t1, *want, *got)
    for a, b in zip(got, dense):
        assert torch.equal(a, b)


def test_surface_pass_with_geometric_ao_matches_jax(meshes):
    """``trace_surface_pass`` on the two meshes, AO with 2 hemisphere
    samples per pixel from one key (the tiled lanes: 3072 rays, the AO
    rays in row blocks): the same hits, t within TRI_ULPS of the term
    scale, and the
    shaded background within 1e-5 on 99.5% of the pixels."""
    ref, port = meshes
    fs = dataclasses.replace(
        make_frame_state(
            RefCamera.look_at([70.0, 45.0, 80.0], [0, 0, 0], [0, 1, 0],
                              45.0, 64, 48), 1), ao_enabled=np.bool_(True),
        ao_length=np.float32(12.0))
    o, d, _, _ = _rays()
    key = jax.random.fold_in(jax.random.PRNGKey(0x51AB), 5)
    t_ref, bg_ref = jax.jit(
        R.trace_surface_pass,
        static_argnames=("cfg", "include_iso", "include_contours", "screen"),
    )(None, fs, ref, RefRenderConfig(num_channels=1, ao_samples=2), o, d,
      jax.random.fold_in(key, 3), include_iso=False, include_contours=False,
      screen=(64, 48))
    pkey = prng.fold_in(prng.fold_in(prng.prng_key(0x51AB), 5), 3)
    pfs = interop.frame_state_from_reference(fs)

    def port_pass(ao_samples):
        return P.trace_surface_pass(
            None, pfs, port, RenderConfig(num_channels=1, ao_samples=ao_samples),
            _t(o), _t(d), pkey, include_iso=False, include_contours=False,
            screen=(64, 48))

    t_got, bg_got = port_pass(2)
    t_ref, bg_ref = np.asarray(t_ref), np.asarray(bg_ref)
    hit = t_ref < 1e10
    assert hit.sum() > 50
    np.testing.assert_array_equal(t_got.numpy() < 1e10, hit)
    _assert_tri_t(port, o, d, hit, t_ref, t_got.numpy())
    # an AO ray grazing a triangle's edge can hit in one package and miss
    # in the other (the directions' cos and sin differ in ulps): 3 of
    # these 3072 pixels, each by one sample of two (<= 0.8 / 2)
    dbg = np.abs(bg_got.numpy() - bg_ref).max(-1)
    assert (dbg <= 1e-5).mean() >= 0.995 and dbg.max() <= 0.4 + 1e-5
    # the AO darkens some hits
    assert (port_pass(0)[1] - bg_got).max() > 0.05

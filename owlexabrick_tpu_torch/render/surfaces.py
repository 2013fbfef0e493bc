"""Surface passes: triangle meshes, streamline segments, contour planes
and the exact iso surfaces, their shading and the dense ambient
occlusion (the port of ``owlexabrick_tpu/render/surfaces.py``).

Mirrors traceSurfaces (programs/exabrick.cu:1475-1529) and the raygen
surface shading + AO (exabrick.cu:1596-1651), vectorized over the ray
batch as torch ops.  Contour planes are colored by sampling the exact
scene at the hit (``dvr.locate_leaf`` + ``dvr.sample_basis``); iso
surfaces are the exact iso march (``iso.trace_iso_rays``).  Meshes are a brute-force triangle table; large ones
(``_nearest_surface``: >= 4096 triangles, or >= 2048 segments, and >=
2048 rays, the JAX package's thresholds) take the tiled trace: rays in
blocks of 256 (near-square screen tiles when the batch is a screen),
primitives in Morton-ordered chunks, each block's bounding cone against
each chunk's bounding sphere.  Where the JAX package then scans a padded
candidate table under ``lax.cond`` capacity tiers (static shapes), the
port lists every (block, chunk) candidate pair, keeps the rays of each
pair whose segment [tmin, tmax] passes the chunk's sphere (a
conservative test), and tests those rays against the chunk's
primitives in bounded batches.
Every culling step is conservative, so the nearest hit (the first
primitive in table order on a tie) is the dense trace's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.constants import (PRIMID_ISOSURFACE, PRIMID_PLANE,
                              PRIMID_STREAMLINE)
from ..core.types import TriangleMesh
from . import prng
from .dvr import XFTensors, _affine_rows, _dot3, locate_leaf, sample_basis
from .iso import trace_iso_rays
from .slabs import _sqrt_rn, render_device
from .tracer import morton_order

_INF = float("inf")
# coordinate of a pad primitive (the JAX package's dead-slot value)
_DEAD = 3e10
# ray-primitive tests per batch: each batch holds ~12 float32 temporaries
# of this many elements, which bounds a trace's memory at any width
_BATCH = 1 << 22
# (t bits << 32) | primitive index of "no hit": t = inf, index past any
_NO_HIT = (0x7F800000 << 32) | 0x7FFFFFFF
# default tracer timestep: every segment visible
_ALL_VISIBLE = 1 << 30


@dataclass
class SurfaceData:
    """Flattened triangle soup of every mesh and the streamline segments
    (SurfaceGeomData analog), as tensors on the render device."""

    tri_v0: torch.Tensor  # (T, 3) float32
    tri_e1: torch.Tensor  # (T, 3) float32  (v1 - v0)
    tri_e2: torch.Tensor  # (T, 3) float32  (v2 - v0)
    tri_n: torch.Tensor  # (T, 3) float32 normalized geometric normal

    # streamline segments (rounded cones), hidden when seg_t >= timestep
    seg_a: torch.Tensor  # (S, 3) float32
    seg_b: torch.Tensor  # (S, 3) float32
    seg_t: torch.Tensor  # (S,) int32 timestep of the segment's head
    seg_radius: np.float32  # ()

    @property
    def num_tris(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_segments(self) -> int:
        return int(self.seg_a.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @staticmethod
    def from_arrays(tri_v0, tri_e1, tri_e2, tri_n, seg_a, seg_b, seg_t,
                    seg_radius, device="cuda") -> "SurfaceData":
        """Host arrays (numpy or array-likes) on ``device``."""
        dev = render_device(device)

        def f3(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32).reshape(-1, 3))).to(dev)

        return SurfaceData(
            tri_v0=f3(tri_v0), tri_e1=f3(tri_e1), tri_e2=f3(tri_e2),
            tri_n=f3(tri_n), seg_a=f3(seg_a), seg_b=f3(seg_b),
            seg_t=torch.from_numpy(np.ascontiguousarray(
                np.asarray(seg_t, np.int32).reshape(-1))).to(dev),
            seg_radius=np.float32(seg_radius))

    @staticmethod
    def empty(device="cuda") -> "SurfaceData":
        z = np.zeros((0, 3), np.float32)
        return SurfaceData.from_arrays(z, z, z, z, z, z,
                                       np.zeros(0, np.int32), 2.0, device)

    @staticmethod
    def from_meshes(meshes: List[TriangleMesh],
                    device="cuda") -> "SurfaceData":
        if not meshes:
            return SurfaceData.empty(device)
        v0s, e1s, e2s = [], [], []
        for m in meshes:
            v = np.asarray(m.vertices, np.float32)
            idx = np.asarray(m.indices, np.int64)
            a = v[idx[:, 0]]
            v0s.append(a)
            e1s.append(v[idx[:, 1]] - a)
            e2s.append(v[idx[:, 2]] - a)
        v0 = np.concatenate(v0s)
        e1 = np.concatenate(e1s)
        e2 = np.concatenate(e2s)
        # Morton centroid order keeps the tiled trace's chunk bounding
        # spheres tight (pure reordering; nearest-hit semantics and
        # per-tri shading are order-free)
        order = morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2 = v0[order], e1[order], e2[order]
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        z = np.zeros((0, 3), np.float32)
        return SurfaceData.from_arrays(v0, e1, e2, n, z, z,
                                       np.zeros(0, np.int32), 2.0, device)


# ----------------------------------------------------------------------------
# vector algebra on component triples (each a broadcastable tensor), in the
# reference's operation order
# ----------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _norm(a):
    return _sqrt_rn(_dot(a, a))


def _rows(x, idx):
    """Rows ``idx`` of an (N, 3) tensor as (m, 1) components."""
    return tuple(c[:, None] for c in x[idx].unbind(-1))


def _window(t, tmin, tmax):
    return torch.where((t >= tmin[:, None]) & (t <= tmax[:, None]), t, _INF)


# ----------------------------------------------------------------------------
# triangle soup intersection (Moller-Trumbore)
# ----------------------------------------------------------------------------

def _ray_triangles(o, d, v0, e1, e2):
    """Moller-Trumbore on component triples: ray o + t d against the
    triangles (v0, e1, e2), broadcast.  Returns t, inf for a miss."""
    s1 = _cross(d, e2)
    div = _dot(s1, e1)
    nz = div != 0.0
    inv = torch.where(nz, 1.0 / torch.where(nz, div, 1.0), 0.0)
    dd = _sub(o, v0)
    b1 = _dot(dd, s1) * inv
    s2 = _cross(dd, e1)
    b2 = _dot(d, s2) * inv
    t = _dot(e2, s2) * inv
    ok = nz & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0)
    return torch.where(ok, t, _INF)


def _dense_nearest(p: int, n_prims: int, test):
    """First-minimum hit over every primitive, in batches of rays:
    ``test(slice)`` gives (rays, n_prims) windowed t.  Returns (t (p,),
    index (p,), hit (p,))."""
    ts, ks = [], []
    step = max(1, _BATCH // max(n_prims, 1))
    for i in range(0, p, step):
        t = test(slice(i, i + step))
        k = torch.argmin(t, dim=1)
        ts.append(t.gather(1, k[:, None])[:, 0])
        ks.append(k)
    t = torch.cat(ts)
    return t, torch.cat(ks), torch.isfinite(t)


def trace_triangles(surf: SurfaceData, o, d, tmin, tmax):
    """Nearest mesh hit -> (t_hit (P,), normal (P, 3)); inf and a zero
    normal at a miss."""
    p = o.shape[0]
    if surf.num_tris == 0:
        return (torch.full((p,), _INF, dtype=o.dtype, device=o.device),
                torch.zeros((p, 3), dtype=o.dtype, device=o.device))
    tris = [tuple(c[None] for c in x.unbind(-1))
            for x in (surf.tri_v0, surf.tri_e1, surf.tri_e2)]
    o3, d3 = o.unbind(-1), d.unbind(-1)

    def test(sl):
        t = _ray_triangles(tuple(c[sl, None] for c in o3),
                           tuple(c[sl, None] for c in d3), *tris)
        return _window(t, tmin[sl], tmax[sl])

    t, k, hit = _dense_nearest(p, surf.num_tris, test)
    return t, torch.where(hit[:, None], surf.tri_n[k], 0.0)


# ----------------------------------------------------------------------------
# streamline segments as rounded cones (exabrick.cu:440-573)
# ----------------------------------------------------------------------------

def _ray_capsules(o, d, pa, pb, r):
    """Capsule (equal-radius rounded cone) intersection on component
    triples, broadcast; ``r`` a float32 scalar.  Returns t, inf-miss."""
    rr = float(np.float32(r) * np.float32(r))
    ba = _sub(pb, pa)
    oa = _sub(o, pa)
    baba = _dot(ba, ba)
    bard = _dot(ba, d)
    baoa = _dot(ba, oa)
    rdoa = _dot(d, oa)
    oaoa = _dot(oa, oa)
    # cylinder body
    a = baba - bard * bard
    b = baba * rdoa - baoa * bard
    c = baba * oaoa - baoa * baoa - rr * baba
    h = b * b - a * c
    t_body = (-b - _sqrt_rn(torch.clamp(h, min=0.0))) / torch.where(
        a == 0, 1.0, a)
    y = baoa + t_body * bard
    body_ok = (h >= 0) & (y > 0) & (y < baba) & (a != 0)

    # caps (spheres at both ends)
    def sphere(ctr):
        oc = _sub(o, ctr)
        bq = _dot(oc, d)
        hq = bq * bq - (_dot(oc, oc) - rr)
        tq = -bq - _sqrt_rn(torch.clamp(hq, min=0.0))
        return torch.where(hq >= 0, tq, _INF)

    t_body = torch.where(body_ok, t_body, _INF)
    t = torch.minimum(t_body, torch.minimum(sphere(pa), sphere(pb)))
    return torch.where(t > 0, t, _INF)


def _capsule_normal(o, d, t, pa, pb):
    """Unit normal at the hit t of each ray (rows) on its capsule."""
    hitp = o + t[:, None] * d
    ba = pb - pa
    baba = (ba * ba).sum(-1)
    yy = ((hitp - pa) * ba).sum(-1) / torch.where(baba == 0, 1.0, baba)
    n = hitp - (pa + torch.clamp(yy, 0.0, 1.0)[:, None] * ba)
    nn = _norm(n.unbind(-1))
    return n / torch.clamp(nn, min=1e-20)[:, None]


def _segment_t(o, d, sa, sb, st, radius, current_timestep, tmin, tmax):
    """Windowed capsule t of ray components (m, 1) against segment rows
    (m or 1, C): hidden (seg_t >= timestep) and dead (a coordinate
    >= 2e10) segments miss."""
    t = _ray_capsules(o, d, sa.unbind(-1), sb.unbind(-1), radius)
    dead = (sa.abs() >= 2e10).any(-1) | (sb.abs() >= 2e10).any(-1)
    t = torch.where((st < int(current_timestep)) & ~dead, t, _INF)
    return _window(t, tmin, tmax)


def trace_streamlines(surf: SurfaceData, current_timestep, o, d, tmin, tmax):
    """Nearest visible streamline segment (segments at/after the current
    timestep are hidden, exabrick.cu:536-570) -> (t (P,), normal (P,
    3)), inf and a zero normal at a miss.  ``d`` must be unit vectors
    (the rounded-cone quadratics assume |d| = 1)."""
    p = o.shape[0]
    s = surf.num_segments
    if s == 0:
        return (torch.full((p,), _INF, dtype=o.dtype, device=o.device),
                torch.zeros((p, 3), dtype=o.dtype, device=o.device))
    o3, d3 = o.unbind(-1), d.unbind(-1)
    sa, sb, st = surf.seg_a[None], surf.seg_b[None], surf.seg_t[None]

    def test(sl):
        return _segment_t(tuple(c[sl, None] for c in o3),
                          tuple(c[sl, None] for c in d3), sa, sb, st,
                          surf.seg_radius, current_timestep, tmin[sl],
                          tmax[sl])

    t, k, hit = _dense_nearest(p, s, test)
    return t, _hit_normals(hit, o, d, t, surf.seg_a[k], surf.seg_b[k])


def _hit_normals(hit, o, d, t, pa, pb):
    n = torch.zeros_like(o)
    rows = hit.nonzero()[:, 0]
    n[rows] = _capsule_normal(o[rows], d[rows], t[rows], pa[rows], pb[rows])
    return n


# ----------------------------------------------------------------------------
# tile-culled tracing: primitive chunks (bounding spheres) vs ray blocks
# (bounding cones), then each candidate ray against its chunk's sphere
# ----------------------------------------------------------------------------

def _chunk(x, nc: int, c: int, fill):
    """(N, ...) rows padded with ``fill`` to (nc + 1) * c, as (nc + 1,
    c, ...): the trailing chunk is all pad (the JAX package's junk-slot
    chunk)."""
    pad = torch.full(((nc + 1) * c - x.shape[0], *x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).reshape(nc + 1, c, *x.shape[1:])


def _sphere_of(pts, ok, extra=0.0):
    """Bounding sphere of the points ``pts`` (NC, K, 3) where ``ok``
    (NC, K): the center of their box, half its diagonal (+ ``extra``).
    Returns centers (NC, 3), radii (NC,), alive (NC,)."""
    m = ok[..., None]
    lo = torch.where(m, pts, _DEAD).amin(1)
    hi = torch.where(m, pts, -_DEAD).amax(1)
    ctr = 0.5 * (lo + hi)
    rad = 0.5 * _norm((hi - lo).unbind(-1)) + extra
    alive = ok.any(1)
    return (torch.where(alive[:, None], ctr, 0.0),
            torch.where(alive, rad, 0.0), alive)


def _tri_chunk_bounds(v0, e1, e2):
    """Bounding sphere per triangle chunk; v0/e1/e2: (NC, C, 3).  Pad
    triangles carry |v0| >= 2e10 and zero edges."""
    ok = (v0.abs() < 2e10).all(-1)
    return _sphere_of(torch.cat([v0, v0 + e1, v0 + e2], 1),
                      torch.cat([ok, ok, ok], 1))


def _segment_chunk_bounds(sa, sb, radius):
    """Bounding sphere per segment chunk; sa/sb: (NC, C, 3).  Dead
    endpoints (|coord| >= 2e10) are excluded; an all-dead chunk reports
    alive=False."""
    ok = (sa.abs() < 2e10).all(-1) & (sb.abs() < 2e10).all(-1)
    return _sphere_of(torch.cat([sa, sb], 1), torch.cat([ok, ok], 1),
                      float(radius))


def _ray_block_cones(o_b, d_b, tmax_b):
    """Bounding cone per ray block.  o_b/d_b: (B, G, 3).  Returns apex
    centroid (B, 3), apex radius (B,), unit axis (B, 3), cos half-angle
    (B,), and the block's largest reachable axis coordinate (B,)."""
    oc = o_b.mean(1)
    rho = _norm((o_b - oc[:, None]).unbind(-1)).amax(1)
    axis = d_b.mean(1)
    axis = axis / torch.clamp(_norm(axis.unbind(-1)), min=1e-20)[:, None]
    dn = _norm(d_b.unbind(-1))
    cos_t = torch.clamp(
        (_dot(d_b.unbind(-1), axis[:, None].unbind(-1))
         / torch.clamp(dn, min=1e-20)).amin(1), -1.0, 1.0)
    # ray points sit at axis coordinate <= rho + t*|d|
    x_reach = rho + torch.clamp(tmax_b.amax(1), min=0.0) * dn.amax(1)
    return oc, rho, axis, cos_t, x_reach


def _cone_sphere_overlap(oc, rho, axis, cos_t, x_reach, ctr, rad, alive):
    """Conservative (never-drops) cone-vs-sphere test, (B, NC) mask: the
    plane term is the signed distance to a supporting halfspace of the
    cone, a lower bound on the true distance."""
    v = ctr[None] - oc[:, None, :]
    x = (v * axis[:, None, :]).sum(-1)
    vv = (v * v).sum(-1)
    y = _sqrt_rn(torch.clamp(vv - x * x, min=0.0))
    sin_t = _sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    rr = rad[None] + rho[:, None]
    plane = cos_t[:, None] * y - sin_t[:, None] * x
    hit = (plane <= rr) | (vv <= rr * rr)
    # forward rays only: a sphere wholly behind the apex is unreachable,
    # and one past the farthest t window is too
    hit = hit & (x + rad[None] >= -rho[:, None])
    hit = hit & (x - rad[None] <= x_reach[:, None])
    # incoherent block (half-angle >= ~84 deg): keep every chunk
    hit = torch.where(cos_t[:, None] < 0.1, True, hit)
    return hit & alive[None]


def _screen_tile_perm(w: int, h: int, group: int, device):
    """Row-major pixel order -> near-square screen-tile order, so a
    contiguous block of `group` rays is one tile's bundle.  Returns
    (perm, inverse) int64 on ``device`` (a stable sort: the JAX
    package's permutation)."""
    tw = max(8, int(2 ** np.round(np.log2(max(np.sqrt(group), 1)))))
    th = max(1, group // tw)
    py = torch.arange(h, device=device)[:, None]
    px = torch.arange(w, device=device)[None]
    tile = (py // th) * ((w + tw - 1) // tw) + px // tw
    perm = torch.argsort(tile.reshape(-1), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=device)
    return perm, inv


def _ray_blocks(o, d, tmin, tmax, group: int, screen):
    """Rays in blocks of `group` (screen-tiled when `screen` gives the
    row-major (w, h) shape of the batch; the last block repeats the last
    ray).  Returns blocked o, d, tmin, tmax, the inverse permutation (or
    None) and the block count."""
    p = o.shape[0]
    g = int(group)
    dev = o.device
    inv = None
    nb = -(-p // g)
    idx = torch.clamp(torch.arange(nb * g, device=dev), max=p - 1)
    if screen is not None and int(screen[0]) * int(screen[1]) == p:
        perm, inv = _screen_tile_perm(int(screen[0]), int(screen[1]), g, dev)
        idx = torch.cat([perm, perm[-1:].expand(nb * g - p)])
    return (o[idx].reshape(nb, g, 3), d[idx].reshape(nb, g, 3),
            tmin[idx].reshape(nb, g), tmax[idx].reshape(nb, g), inv, nb)


def _ray_meets_sphere(o, d, tmin, tmax, ctr, rad):
    """Conservatively: does the segment o + t d, t in [tmin, tmax] (|d| =
    1), pass within ``rad`` of ``ctr``?  (m, 3) rows; a margin of 1e-5 of
    the distances covers float32 rounding here and in the hit tests."""
    v = ctr - o
    tc = torch.minimum(torch.maximum((v * d).sum(-1), tmin), tmax)
    w = v - tc[:, None] * d
    tol = 1e-5 * (torch.linalg.vector_norm(v, dim=-1) + tc.abs()) \
        + 1e-4 * (rad + 1.0)
    return (w * w).sum(-1) <= (rad + tol) ** 2


def _tiled_nearest(pb, pc, o_f, d_f, t0_f, t1_f, g: int, c: int, ctr, rad,
                   test):
    """First-minimum hit over the candidate (block, chunk) pairs (pb, pc)
    of rays in blocks of ``g`` (o_f ... flattened block rays) and chunks
    of ``c`` primitives: each pair's rays that meet the chunk's sphere
    are tested against its primitives, ``test(rays, chunks)`` -> (m, c)
    windowed t.  Returns (t (NB*G,), primitive index (NB*G,), hit, the
    count of rays that met their chunk's sphere)."""
    dev = o_f.device
    best = torch.full((o_f.shape[0],), _NO_HIT, dtype=torch.int64,
                      device=dev)
    lane = torch.arange(g, device=dev)
    step = max(1, _BATCH // g)
    sub = max(1, _BATCH // c)
    meets = 0
    for i in range(0, pb.shape[0], step):
        ray = (pb[i:i + step, None] * g + lane).reshape(-1)
        chunk = pc[i:i + step].repeat_interleave(g)
        keep = _ray_meets_sphere(o_f[ray], d_f[ray], t0_f[ray], t1_f[ray],
                                 ctr[chunk], rad[chunk])
        ray, chunk = ray[keep], chunk[keep]
        meets += ray.shape[0]
        for j in range(0, ray.shape[0], sub):
            r, ch = ray[j:j + sub], chunk[j:j + sub]
            t = test(r, ch)
            k = torch.argmin(t, dim=1)
            tk = t.gather(1, k[:, None])[:, 0]
            # one int64 key orders by t, then by primitive index (the
            # first primitive wins a tie, as in a scan in table order)
            key = (tk.view(torch.int32).to(torch.int64) << 32) | (ch * c + k)
            key = torch.where(torch.isfinite(tk), key, _NO_HIT)
            best.scatter_reduce_(0, r, key, "amin")
    t = (best >> 32).to(torch.int32).view(torch.float32)
    return t, best & 0xFFFFFFFF, best != _NO_HIT, meets


def _unblock(x, p: int, inv):
    x = x[:p]
    return x if inv is None else x[inv]


def _tiled(bounds, c: int, o, d, tmin, tmax, group, screen, test, work):
    """Shared body of the tiled traces; returns block-flat (t, index,
    hit), the flattened block rays and the unblocking data, and adds the
    trace's work to the dict ``work``.  Every cone-sphere candidate pair
    is tested (the candidates never drop a hit, so the result is exact
    whatever their count)."""
    ctr, rad, alive = bounds
    o_b, d_b, tmin_b, tmax_b, inv, nb = _ray_blocks(o, d, tmin, tmax, group,
                                                    screen)
    mask = _cone_sphere_overlap(*_ray_block_cones(o_b, d_b, tmax_b), ctr,
                                rad, alive)
    pb, pc = mask.nonzero().unbind(1)
    g = int(group)
    o_f, d_f = o_b.reshape(-1, 3), d_b.reshape(-1, 3)
    t0_f, t1_f = tmin_b.reshape(-1), tmax_b.reshape(-1)
    t, k, hit, meets = _tiled_nearest(
        pb, pc, o_f, d_f, t0_f, t1_f, g, c, ctr, rad,
        lambda r, ch: test(_rows(o_f, r), _rows(d_f, r), ch, t0_f[r],
                           t1_f[r]))
    for key, n in (("calls", 1), ("rays", o.shape[0]), ("blocks", nb),
                   ("chunks", ctr.shape[0] - 1), ("pairs", pb.shape[0]),
                   ("sphere_tests", pb.shape[0] * g),
                   ("rays_meeting", meets), ("primitive_tests", meets * c)):
        work[key] = work.get(key, 0) + int(n)
    return t, k, hit, o_f, d_f, inv


def trace_triangles_tiled(surf: SurfaceData, o, d, tmin, tmax, *,
                          group: int = 256, tri_chunk: int = 64,
                          screen=None):
    """Exact nearest mesh hit with two-level culling: triangle chunks
    (bounding spheres; ``SurfaceData.from_meshes`` emits triangles in
    Morton centroid order so chunks are tight) vs ray-block bounding
    cones, then each candidate ray vs its chunk's sphere.  Equals
    :func:`trace_triangles` (normals zero at a miss).  ``d`` must be unit
    vectors.  Reference: two-level mesh BVH, exa/OptixRenderer.cpp +
    programs/exabrick.cu:1475-1529."""
    p = o.shape[0]
    c = int(tri_chunk)
    nc = -(-surf.num_tris // c)
    v0 = _chunk(surf.tri_v0, nc, c, _DEAD)
    e1 = _chunk(surf.tri_e1, nc, c, 0.0)
    e2 = _chunk(surf.tri_e2, nc, c, 0.0)
    nr = _chunk(surf.tri_n, nc, c, 0.0).reshape(-1, 3)

    def test(o_r, d_r, ch, t0, t1):
        return _window(_ray_triangles(o_r, d_r, v0[ch].unbind(-1),
                                      e1[ch].unbind(-1), e2[ch].unbind(-1)),
                       t0, t1)

    t, k, hit, _, _, inv = _tiled(_tri_chunk_bounds(v0, e1, e2), c, o, d,
                                  tmin, tmax, group, screen, test,
                                  trace_triangles_tiled.work)
    n = torch.where(hit[:, None], nr[torch.where(hit, k, 0)], 0.0)
    return _unblock(t, p, inv), _unblock(n, p, inv)


# each tiled trace's work since its dict was last cleared: calls, rays,
# ray blocks, primitive chunks, candidate (block, chunk) pairs, the
# ray-sphere tests they hold, the rays that met their chunk's sphere and
# the ray-primitive tests those took (host counts, known without a sync)
trace_triangles_tiled.work = {}


def trace_streamlines_tiled(surf: SurfaceData, current_timestep, o, d,
                            tmin, tmax, *, group: int = 256,
                            seg_chunk: int = 32, screen=None):
    """Exact nearest streamline hit with the same two-level culling as
    :func:`trace_triangles_tiled` (segment chunks; the tracer's Morton
    seed order keeps them tight).  Equals :func:`trace_streamlines`.
    ``d`` must be unit vectors; ``screen=(w, h)``: the row-major screen
    shape of the ray batch (rays regrouped into near-square tiles).
    The TPU-first replacement for the reference's per-frame streamline
    BVH rebuild (exa/OptixRenderer.cpp:476-487)."""
    p = o.shape[0]
    c = int(seg_chunk)
    nc = -(-surf.num_segments // c)
    sa = _chunk(surf.seg_a, nc, c, _DEAD)
    sb = _chunk(surf.seg_b, nc, c, _DEAD)
    st = _chunk(surf.seg_t, nc, c, 0)
    radius = surf.seg_radius

    def test(o_r, d_r, ch, t0, t1):
        return _segment_t(o_r, d_r, sa[ch], sb[ch], st[ch], radius,
                          current_timestep, t0, t1)

    t, k, hit, o_f, d_f, inv = _tiled(
        _segment_chunk_bounds(sa, sb, radius), c, o, d, tmin, tmax, group,
        screen, test, trace_streamlines_tiled.work)
    kk = torch.where(hit, k, 0)
    n = _hit_normals(hit, o_f, d_f, t, sa.reshape(-1, 3)[kk],
                     sb.reshape(-1, 3)[kk])
    return _unblock(t, p, inv), _unblock(n, p, inv)


trace_streamlines_tiled.work = {}


# ----------------------------------------------------------------------------
# combined surface pass + shading + AO
# ----------------------------------------------------------------------------

# ----------------------------------------------------------------------------
# contour planes (exabrick.cu:1267-1406)
# ----------------------------------------------------------------------------

def trace_contour_planes(scene, fs, cfg, o, d, tmin, tmax):
    """Nearest enabled contour plane hit inside the world bounds box,
    colored by the field there.  Returns (t (P,), color (P, 3), normal
    (P, 3)); t inf where no plane is hit.

    The reference clips the plane to the bounds box and intersects the
    polygon; a hit point inside the box is the same test.  The plane's
    offset is fractional in the bounds box (exabrick.cu:1356-1362):
    dot(n, (p - lo) / span) = offset."""
    p = o.shape[0]
    dev = d.device
    t_best = torch.full((p,), _INF, dtype=d.dtype, device=dev)
    color = torch.zeros((p, 3), dtype=d.dtype, device=dev)
    normal = torch.zeros((p, 3), dtype=d.dtype, device=dev)
    w_lo, w_hi = scene.world_bounds_lo, scene.world_bounds_hi
    span = w_hi - w_lo
    xf = XFTensors.from_frame(fs, dev)
    o = o.expand(p, 3)
    for i in range(len(fs.contour_enabled)):
        if not bool(fs.contour_enabled[i]):
            continue
        n = torch.as_tensor(np.asarray(fs.contour_normal[i], np.float32),
                            device=dev)
        ns = n / span
        off = (torch.as_tensor(np.float32(fs.contour_offset[i]), device=dev)
               + (ns[0] * w_lo[0] + ns[1] * w_lo[1] + ns[2] * w_lo[2]))
        denom = _dot3(n[None], d)
        nsd = _dot3(ns[None], d)
        t = (off - _dot3(ns[None], o)) / torch.where(denom == 0, 1.0, nsd)
        hitp = o + t[:, None] * d
        inside = ((hitp >= w_lo) & (hitp <= w_hi)).all(-1)
        ok = ((nsd != 0) & inside & (t >= tmin) & (t <= tmax)
              & (t < t_best))
        at = torch.nonzero(ok)[:, 0]
        if at.numel() == 0:
            continue
        # the field at the hit colormaps the plane (samplePointWithInfRay,
        # exabrick.cu:818-830: the value is used whether the sample is
        # valid or not)
        pv = _affine_rows(hitp[at], scene.voxel_from_world, True)
        rid = scene.tree_leaf[locate_leaf(scene, pv)]
        c = min(max(int(fs.contour_channel[i]), 0), cfg.num_channels - 1)
        _, val = _sample_channel(scene, cfg, torch.clamp(rid, min=0), pv, c)
        rgba = _lookup_channel(xf, cfg, c, val)
        t_best[at] = t[at]
        color[at] = rgba[:, :3]
        normal[at] = n
    return t_best, color, normal


def _sample_channel(scene, cfg, rid, pos, channel: int):
    """sample_basis of one channel (the JAX package's traced-index
    switch; here the channel is a host int)."""
    return sample_basis(scene, rid, pos, channel if cfg.num_channels > 1
                        else 0)


def _lookup_channel(xf: XFTensors, cfg, channel: int, value):
    """The channel's transfer function at ``value`` (..., 4)."""
    return xf.lookup(channel if cfg.num_channels > 1 else 0, value)


# ----------------------------------------------------------------------------
# combined surface pass + shading + AO
# ----------------------------------------------------------------------------

def _nearest_surface(scene, fs, surf: SurfaceData, cfg, o, d, tmin, tmax,
                     include_contours: bool, include_iso: bool,
                     current_timestep=None, screen=None):
    """traceSurfaces: nearest hit among meshes, contour planes,
    streamlines and iso surfaces.  Returns (t, normal, base_color,
    ambient, kind).  ``scene`` (the exact scene) is read only for
    contour planes and iso surfaces: None will do where neither is
    asked for."""
    p = o.shape[0]
    dev = o.device
    t = torch.full((p,), _INF, dtype=o.dtype, device=dev)
    normal = torch.zeros((p, 3), dtype=o.dtype, device=dev)
    base = torch.zeros((p, 3), dtype=o.dtype, device=dev)
    ambient = torch.zeros((p,), dtype=o.dtype, device=dev)
    kind = torch.full((p,), -1, dtype=torch.int32, device=dev)

    if surf.num_tris >= 4096 and p >= 2048:
        tt, tn = trace_triangles_tiled(surf, o, d, tmin, tmax, screen=screen)
    else:
        tt, tn = trace_triangles(surf, o, d, tmin, tmax)
    win = tt < t
    t = torch.where(win, tt, t)
    normal = torch.where(win[:, None], tn, normal)
    base = torch.where(win[:, None], 0.8, base)
    ambient = torch.where(win, 0.2, ambient)
    kind = torch.where(win, 0, kind)

    if include_contours and bool(np.any(fs.contour_enabled)):
        ct, cc, cn = trace_contour_planes(scene, fs, cfg, o, d, tmin, tmax)
        win = ct < t
        t = torch.where(win, ct, t)
        normal = torch.where(win[:, None], cn, normal)
        base = torch.where(win[:, None], cc, base)
        ambient = torch.where(win, 0.0, ambient)
        kind = torch.where(win, PRIMID_PLANE, kind)

    if surf.num_segments > 0:
        # default: every segment visible (a live tracer animates by
        # passing its current timestep)
        ts = _ALL_VISIBLE if current_timestep is None else current_timestep
        if surf.num_segments >= 2048 and p >= 2048:
            st, sn = trace_streamlines_tiled(surf, ts, o, d, tmin, tmax,
                                             screen=screen)
        else:
            st, sn = trace_streamlines(surf, ts, o, d, tmin, tmax)
        win = st < t
        t = torch.where(win, st, t)
        normal = torch.where(win[:, None], sn, normal)
        base = torch.where(win[:, None], torch.tensor(
            [0.8, 0.2, 0.1], dtype=o.dtype, device=dev), base)
        ambient = torch.where(win, 0.2, ambient)
        kind = torch.where(win, PRIMID_STREAMLINE, kind)

    if include_iso and cfg.iso_surfaces:
        it, in_, ic = trace_iso_rays(scene, fs, cfg, o, d, tmin, tmax)
        win = it < t
        t = torch.where(win, it, t)
        normal = torch.where(win[:, None], in_, normal)
        base = torch.where(win[:, None], ic, base)
        ambient = torch.where(win, 0.0, ambient)
        kind = torch.where(win, PRIMID_ISOSURFACE, kind)
    return t, normal, base, ambient, kind


def _onb(w):
    """make_orthonormal_basis (exabrick.cu:78-83), batched."""
    cond = (w[:, 0].abs() > w[:, 1].abs())[:, None]
    zero = torch.zeros_like(w[:, 0])
    v1 = torch.stack([-w[:, 2], zero, w[:, 0]], -1)
    v2 = torch.stack([zero, w[:, 2], -w[:, 1]], -1)
    v = torch.where(cond, v1, v2)
    v = v / torch.clamp(_norm(v.unbind(-1)), min=1e-20)[:, None]
    u = torch.stack(_cross(v.unbind(-1), w.unbind(-1)), -1)
    return u, v


def trace_surface_pass(scene, fs, surf: SurfaceData, cfg, o, d, key,
                       include_iso: bool = True,
                       include_contours: bool = True, screen=None):
    """Full surface pass of the raygen program: nearest surface, AO,
    shaded background color.  ``key``: a ``prng`` key (the frame's).
    Returns (t_hit (P,), bg (P, 3)), 2e10 where nothing is hit.
    ``include_iso=False`` leaves implicit iso surfaces to the caller
    (the slab fast path sweeps them).

    AO: ``cfg.ao_samples`` cosine-weighted hemisphere rays per pixel
    against everything but the contour planes, the exact iso surfaces
    included when ``cfg.iso_surfaces`` (exabrick.cu:1612-1645), gated by
    ``fs.ao_enabled``."""
    p = o.shape[0]
    dev = o.device
    tmin = torch.full((p,), 1e-6, dtype=o.dtype, device=dev)
    tmax = torch.full((p,), 2e10, dtype=o.dtype, device=dev)
    t, n, base, ambient, _ = _nearest_surface(
        scene, fs, surf, cfg, o, d, tmin, tmax, screen=screen,
        include_contours=include_contours, include_iso=include_iso,
        current_timestep=getattr(fs, "tracer_timestep", None))
    hit = torch.isfinite(t)
    has_n = _norm(n.unbind(-1)) > 0.0

    shadow = torch.zeros((p,), dtype=o.dtype, device=dev)
    if cfg.ao_samples > 0:
        isect = torch.where(hit[:, None], o + t[:, None] * d, o)
        u, v = _onb(n)
        hits = torch.zeros((p,), dtype=o.dtype, device=dev)
        for s in range(cfg.ao_samples):
            r = prng.uniform(prng.fold_in(key, s), (p, 2), dev)
            rr = _sqrt_rn(r[:, 0])
            theta = 2.0 * math.pi * r[:, 1]
            dir_ = ((rr * torch.cos(theta))[:, None] * u
                    + (rr * torch.sin(theta))[:, None] * v
                    + _sqrt_rn(1.0 - r[:, 0])[:, None] * n)
            dir_ = dir_ / torch.clamp(_norm(dir_.unbind(-1)),
                                      min=1e-20)[:, None]
            at = _nearest_surface(
                scene, fs, surf, cfg, isect, dir_,
                torch.full((p,), 1e-4, dtype=o.dtype, device=dev),
                torch.full((p,), float(np.float32(fs.ao_length)),
                           dtype=o.dtype, device=dev),
                include_contours=False, include_iso=cfg.iso_surfaces)[0]
            hits = hits + torch.isfinite(at).to(o.dtype)
        if bool(fs.ao_enabled):
            shadow = hits / cfg.ao_samples

    shaded = ambient[:, None] + base * (
        _dot(d.unbind(-1), n.unbind(-1)).abs() * (1.0 - shadow))[:, None]
    bg = torch.where(hit[:, None], torch.where(has_n[:, None], shaded, base),
                     0.0)
    return torch.where(hit, t, 2e10), bg

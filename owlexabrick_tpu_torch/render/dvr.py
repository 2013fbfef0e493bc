"""The exact DVR core (the port of ``owlexabrick_tpu/render/dvr.py``):
BSP point location, basis-function sampling and the region march, plus
frame finishing (sRGB, background composite, progressive accumulation,
RGBA8 packing) and the ray-box slab test.

Each ray finds the region it is in by a stackless descent of the region
BSP (``locate_leaf``: ``tree_depth`` gathers), marches sample intervals
inside it (integrateBrick, exabrick.cu:1116-1185) and advances past its
exit.  Holes and regions the transfer function culls are skipped whole
(exabrick.cu:283-331), the per-region active mask recomputed from the
frame's transfer function.

Where the JAX package steps every ray in lockstep under per-ray masks
(XLA needs static shapes), the port marches only the rays still alive:
each region iteration gathers the live rays by index, each sample step
the rays still marching in their region, and finished rays are scattered
back.  A frame's rays go through in batches (``ray_batch``) so the
(P, K, 8) sampling temporaries stay bounded.  No ray's arithmetic
depends on the others, so the result is the lockstep march's.  The walk
(``march_rays``) takes the per-sample work as a functor, as the
reference's integration functors do: the composite here, the crossing
detection in ``iso.py``.
Formulas keep the reference's float32 operation order; the power and
square root are rounded once through float64, so a value does not
depend on where its ray sits in a batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.constants import (
    EMPTY_CELL_POISON_VALUE,
    REGION_ADVANCE_EPS,
    TERMINATION_THRESHOLD,
)
from .slabs import _sqrt_rn, render_device
from .xf import active_for_volume_sampling, lookup_xf


@dataclass(frozen=True)
class RenderConfig:
    """Render options (the JAX package's ``RenderConfig``: same fields,
    same defaults).

    The slab fast path reads ``num_channels``, the shading and iso
    switches, ``ao_samples`` / ``ao_dirs``, ``colormap_channel`` and
    ``adaptive_stride``; the exact path reads the rest.
    ``wavefront_compaction`` picks the Renderer's packed exact route, as
    in the JAX Renderer: on, ``wavefront.trace_dvr_packed_compacted``;
    off, ``render_step_packed`` (the port marches only live rays either
    way, so the two give the same frame)."""

    num_channels: int = 1
    gradient_shading_dvr: bool = False
    gradient_shading_iso: bool = True
    space_skipping: bool = True
    max_region_iters: int = 512
    # surface passes
    iso_surfaces: bool = False
    ao_samples: int = 0
    # fast-path AO only: candidate directions per frame of the lattice
    # estimator (render/ao_sweep.py)
    ao_dirs: int = 4
    # secondary field that colormaps iso surfaces (LaunchParams.h:59-60)
    colormap_channel: int = 0
    # EXPLICIT_BASIS_METHOD parity: True = basis reconstruction over
    # same-bricks regions (exa/common.h:62-64); False = nearest-cell
    # sampling over per-brick leaves (build the scene with
    # basis_method=False)
    basis_method: bool = True
    # ANALYTIC_GRADIENTS parity (CMakeLists.txt:65-67): False shades with
    # central differences (gradientCD, exabrick.cu:832-880)
    analytic_gradients: bool = True
    # ALLOW_EMPTY_CELLS parity (CMakeLists.txt:73): cells holding
    # EMPTY_CELL_POISON_VALUE leave the basis sum (exabrick.cu:614-618)
    allow_empty_cells: bool = False
    # FAST_CENTRAL_DIFFERENCES parity (CMakeLists.txt:80-82): CD offset
    # samples stay in the current region (exabrick.cu:850-852)
    fast_central_differences: bool = False
    # adaptive z-stride on the slab fast path (exabrick.cu:1129)
    adaptive_stride: bool = True
    # the JAX package's wavefront ray-queue compaction switch
    wavefront_compaction: bool = True


# ----------------------------------------------------------------------------
# frame tensors and small helpers
# ----------------------------------------------------------------------------

@dataclass
class XFTensors:
    """A frame's transfer functions on the render device: ``lut`` (C,
    128, 4), ``domain`` (C, 2), and the float32 scalars ``opacity`` and
    ``dt`` as Python floats."""

    lut: torch.Tensor
    domain: torch.Tensor
    opacity: float
    dt: float

    @staticmethod
    def from_frame(fs, device) -> "XFTensors":
        dev = render_device(device)
        return XFTensors(
            lut=torch.as_tensor(np.asarray(fs.xf_lut, np.float32),
                                device=dev),
            domain=torch.as_tensor(np.asarray(fs.xf_domain, np.float32),
                                   device=dev),
            opacity=float(np.float32(fs.xf_opacity_scale)),
            dt=float(np.float32(fs.dt)))

    def lookup(self, c: int, value: torch.Tensor) -> torch.Tensor:
        return lookup_xf(self.lut[c], self.domain[c], self.opacity, value)


def _pow_rn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 x**y rounded once, through float64 (the same bits
    wherever the element sits in a vectorized loop)."""
    return torch.pow(x.double(), y.double()).float()


def _dot3(a, b):
    """Row-wise dot product of (P, 3) tensors, ((a0 b0 + a1 b1) + a2 b2)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _norm3(a):
    return _sqrt_rn(_dot3(a, a))


def _affine_rows(p, m, offset: bool):
    """Rows p (P, 3) through the 3x4 affine m (a tensor): p @ m[:, :3].T
    (+ m[:, 3]), each output a left-to-right sum."""
    cols = []
    for j in range(3):
        v = p[:, 0] * m[j, 0] + p[:, 1] * m[j, 1] + p[:, 2] * m[j, 2]
        cols.append(v + m[j, 3] if offset else v)
    return torch.stack(cols, 1)


def ray_batch(scene, points_per_ray: int = 1) -> int:
    """Rays marched together.  A sample step of n rays that each sample
    ``points_per_ray`` points (6 for central differences) builds (n
    points, K, 8) temporaries; the batch keeps each near 2^27 elements
    (0.5 GB in float32, 1 GB for the int64 cell index), so a 1080p frame
    of a scene with K = 13 bricks per region goes in two batches.
    Analytic gradients add more temporaries of that size, not larger
    ones.  Each batch costs the host the same launches whatever its size
    (the march is host-bound), so fewer, larger batches are faster."""
    return max(1 << 14, (1 << 27) // (8 * scene.max_bricks_per_region
                                      * points_per_ray))


# ----------------------------------------------------------------------------
# BSP point location
# ----------------------------------------------------------------------------

def locate_leaf(scene, p: torch.Tensor) -> torch.Tensor:
    """The BSP leaf node holding each point: p (P, 3) -> (P,) int64."""
    node = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for _ in range(scene.tree_depth):
        axis = scene.tree_axis[node]
        split = scene.tree_split[node]
        child = scene.tree_child[node].to(torch.int64)
        pax = p.gather(1, axis.clamp(0, 2).to(torch.int64)[:, None])[:, 0]
        node = torch.where(axis < 3, child + (pax >= split), node)
    return node


def ray_box(o, d, lo, hi, tmin, tmax):
    """Slab test of rays o + t d (d (P, 3); o (P, 3), or (3,) for one
    eye) against boxes [lo, hi] ((3,) or (P, 3)), clipped to [tmin, tmax]
    (P,); returns (hit, t0, t1), float32 like the reference's."""
    inv = 1.0 / d
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    t_nr = torch.minimum(t_lo, t_hi)
    t_fr = torch.maximum(t_lo, t_hi)
    t0 = torch.maximum(tmin, t_nr.amax(dim=-1))
    t1 = torch.minimum(tmax, t_fr.amin(dim=-1))
    return t0 < t1, t0, t1


def ray_box_root(scene, o, d, tmin, tmax):
    """The rays against the BSP root box (the union of region domains)."""
    return ray_box(o, d, scene.tree_lo[0], scene.tree_hi[0], tmin, tmax)


# ----------------------------------------------------------------------------
# basis-function sampling (addBasisFunctions, exabrick.cu:620-816)
# ----------------------------------------------------------------------------

def _axis_taps(local_a, size_a):
    """One axis of a sample's 2-tap tent: the low corner index (clamped
    at -1), its (low, high) weights, in-bounds flags and clamped
    indices, each (P, K, 2)."""
    idx_lo = torch.clamp(torch.floor(local_a).to(torch.int32), min=-1)
    frac = local_a - idx_lo.to(local_a.dtype)
    w = torch.stack([1.0 - frac, frac], -1)
    idx = idx_lo[..., None] + torch.arange(2, dtype=torch.int32,
                                           device=local_a.device)
    size = size_a[..., None]
    inb = (idx >= 0) & (idx < size)
    ic = torch.minimum(torch.clamp(idx, min=0),
                       torch.clamp(size - 1, min=0))
    return w, inb, ic.to(torch.int64)


def _corners(x, y, z):
    """(P, K, 2) per-axis tensors as views that broadcast to (P, K, 2, 2,
    2): the 8 corners, z slowest and x fastest (the reference's corner
    order)."""
    return (x[:, :, None, None, :], y[:, :, None, :, None],
            z[:, :, :, None, None])


def sample_basis(scene, rid, pos, channel: int, need_grad: bool = False,
                 allow_empty: bool = False):
    """The basis-weighted field of ``channel`` at points pos (P, 3) lying
    in regions rid (P,).  Returns (ok, value[, grad]), grad the
    quotient-rule numerator (exabrick.cu:916-921).

    ``allow_empty``: ALLOW_EMPTY_CELLS parity — corners whose scalar is
    EMPTY_CELL_POISON_VALUE add neither weight nor value
    (exabrick.cu:614-618)."""
    p = pos.shape[0]
    bids = scene.region_bricks[rid]  # (P, K)
    valid_b = bids >= 0
    b = torch.clamp(bids, min=0).to(torch.int64)
    lower = scene.brick_lower[b]  # (P, K, 3)
    size = scene.brick_size[b]  # (P, K, 3)
    cw = scene.brick_cell_width[b]  # (P, K)
    begin = scene.brick_begin[b].to(torch.int64)  # (P, K)

    local = (pos[:, None, :] - lower) / cw[..., None] - 0.5
    (wx, okx, ix), (wy, oky, iy), (wz, okz, iz) = (
        _axis_taps(local[..., a], size[..., a]) for a in range(3))
    bx, by, bz = _corners(wx, wy, wz)
    w = (bx * by) * bz  # (P, K, 2, 2, 2)
    ox, oy, oz = _corners(okx, oky, okz)
    live = ox & oy & oz & valid_b[:, :, None, None, None]
    cx, cy, cz = _corners(ix, iy, iz)
    sx = size[..., 0].to(torch.int64)[:, :, None, None, None]
    sy = size[..., 1].to(torch.int64)[:, :, None, None, None]
    lin = begin[:, :, None, None, None] + cx + sx * (cy + sy * cz)
    s = scene.scalars[channel][lin]  # (P, K, 2, 2, 2) gather

    if allow_empty:
        live = live & (s != EMPTY_CELL_POISON_VALUE)
    w = torch.where(live, w, 0.0).reshape(p, -1)
    s = s.reshape(p, -1)
    sw = w.sum(-1)
    swv = (w * s).sum(-1)
    ok = sw > 1e-20
    value = swv / torch.where(ok, sw, 1.0)
    if not need_grad:
        return ok, value

    # d/dx of a corner's weight = (wz wy) * (+1 high, -1 low corner), ...
    sign = torch.arange(2, dtype=pos.dtype, device=pos.device) * 2.0 - 1.0
    live = live.reshape(p, -1)
    comps = [torch.where(live, (pair * sg).reshape(p, -1), 0.0)
             for pair, sg in ((bz * by, sign), (bz * bx, sign[:, None]),
                              (by * bx, sign[:, None, None]))]
    sdc = torch.stack([c.sum(-1) for c in comps], -1)
    sd = torch.stack([(c * s).sum(-1) for c in comps], -1)
    return ok, value, sw[:, None] * sd - swv[:, None] * sdc


def sample_nearest(scene, rid, pos, channel: int):
    """Non-basis sampling: the clamp-to-brick nearest cell
    (exabrick.cu:807-815), each region one brick.  Always valid."""
    b = torch.clamp(scene.region_bricks[rid][:, 0], min=0).to(torch.int64)
    lower = scene.brick_lower[b]
    size = scene.brick_size[b]
    cw = scene.brick_cell_width[b]
    begin = scene.brick_begin[b].to(torch.int64)
    idx = torch.floor((pos - lower) / cw[:, None]).to(torch.int32)
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(size - 1, min=0)).to(torch.int64)
    size = size.to(torch.int64)
    lin = begin + idx[:, 0] + size[:, 0] * (idx[:, 1] + size[:, 1] * idx[:, 2])
    value = scene.scalars[channel][lin]
    return torch.ones_like(value, dtype=torch.bool), value


def gradient_cd(scene, pos, channel: int, delta, basis_method: bool = True,
                act_mask=None, fixed_rid=None, allow_empty: bool = False):
    """Central-difference gradient (gradientCD, exabrick.cu:832-880):
    f(pos - δe_i) - f(pos + δe_i) per axis, the reference's sign.

    Each offset point is relocated in the BSP (FAST_CENTRAL_DIFFERENCES
    off); one outside the domain, or in a region ``act_mask`` culls,
    adds 0.  With ``fixed_rid`` (P,) they stay in the caller's region."""
    p = pos.shape[0]
    delta = torch.as_tensor(delta, dtype=pos.dtype,
                            device=pos.device).expand(p)
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    offs = torch.cat([eye, -eye], 0)  # +x +y +z, then -x -y -z
    q = (pos[None] + offs[:, None, :] * delta[None, :, None]).reshape(-1, 3)
    if fixed_rid is not None:
        rc = fixed_rid.repeat(6)
        inside = torch.ones(6 * p, dtype=torch.bool, device=pos.device)
    else:
        rid = scene.tree_leaf[locate_leaf(scene, q)]
        inside = rid >= 0
        rc = torch.clamp(rid, min=0)
        if act_mask is not None:
            inside = inside & act_mask[rc]
    if basis_method:
        ok, v = sample_basis(scene, rc, q, channel, allow_empty=allow_empty)
    else:
        ok, v = sample_nearest(scene, rc, q, channel)
    v = torch.where(inside & ok, v, 0.0).reshape(6, p)
    return (v[3:] - v[:3]).T


# ----------------------------------------------------------------------------
# per-frame region activity (TF-aware space skipping)
# ----------------------------------------------------------------------------

def region_active_mask(scene, xf: XFTensors, num_channels: int):
    """(N,) bool: does any channel's transfer function give the region's
    value range non-zero opacity? (exabrick.cu:250-304)"""
    vr = scene.region_value_range
    m = torch.zeros(vr.shape[0], dtype=torch.bool, device=vr.device)
    for c in range(num_channels):
        m = m | active_for_volume_sampling(xf.lut[c], xf.domain[c],
                                           xf.opacity, vr)
    return m


# ----------------------------------------------------------------------------
# the integrator
# ----------------------------------------------------------------------------

def _sample_grid(dt, t0, offset):
    """The first sample boundary t_i >= t0 on the ray's grid
    (offset + i) dt, with the reference's fix-up steps
    (exabrick.cu:1141-1144)."""
    i0 = torch.ceil((t0 - dt * offset) / dt)
    t_i = (offset + i0) * dt
    for _ in range(3):
        t_i = torch.where(t_i - dt >= t0, t_i - dt, t_i)
    for _ in range(3):
        t_i = torch.where(t_i < t0, t_i + dt, t_i)
    return t_i


def _march_step(scene, xf: XFTensors, cfg: RenderConfig, act_mask, rid, d,
                finest_cw, pos, actual_dt, state):
    """The DVR sample step (``march_rays``'s ``sample``): each channel's
    sample at pos in region rid, classification, shading, opacity
    correction over ``actual_dt`` and the front-to-back composite into
    ``state`` = [rgba (n, 4)].  Returns ([rgba], saturated)."""
    rgba, = state
    take_dt = actual_dt != 0.0
    for c in range(cfg.num_channels):
        grad = None
        if not cfg.basis_method:
            ok, value = sample_nearest(scene, rid, pos, c)
            if cfg.gradient_shading_dvr:
                # non-basis mode shades by central differences with
                # delta = (level + 1) / 2 (exabrick.cu:930-940)
                lvl = torch.log2(finest_cw)
                grad = gradient_cd(
                    scene, pos, c, (lvl + 1.0) * 0.5, False, act_mask,
                    rid if cfg.fast_central_differences else None)
        elif cfg.gradient_shading_dvr and not cfg.analytic_gradients:
            ok, value = sample_basis(scene, rid, pos, c,
                                     allow_empty=cfg.allow_empty_cells)
            # delta = (finestLevelCellWidth + 1) / 2 (exabrick.cu:924)
            grad = gradient_cd(
                scene, pos, c, (finest_cw + 1.0) * 0.5, True, act_mask,
                rid if cfg.fast_central_differences else None,
                allow_empty=cfg.allow_empty_cells)
        elif cfg.gradient_shading_dvr:
            ok, value, grad = sample_basis(scene, rid, pos, c, True,
                                           allow_empty=cfg.allow_empty_cells)
        else:
            ok, value = sample_basis(scene, rid, pos, c,
                                     allow_empty=cfg.allow_empty_cells)
        sample = xf.lookup(c, value)
        rgb, a = sample[:, :3], sample[:, 3]
        if grad is not None:
            g2 = _dot3(grad, grad)
            shade = _dot3(-d, grad).abs() / _sqrt_rn(torch.clamp(g2,
                                                                  min=1e-38))
            use = _sqrt_rn(g2) > finest_cw * 1e-6
            rgb = torch.where(use[:, None], rgb * shade[:, None], rgb)
        rgba = composite(rgba, rgb, a, ok & take_dt, actual_dt)
    return [rgba], rgba[:, 3] >= TERMINATION_THRESHOLD


def composite(rgba, rgb, a, take, actual_dt):
    """One classified sample composited front to back into rgba (n, 4):
    the opacity corrected over ``actual_dt`` (1 - (1 - a)^dt), then added
    where ``take`` (integrateBrick, exabrick.cu:1160-1175)."""
    a = 1.0 - _pow_rn(1.0 - a, actual_dt)
    contrib = torch.where(take, (1.0 - rgba[:, 3]) * a, 0.0)
    return torch.cat([rgba[:, :3] + contrib[:, None] * rgb,
                      (rgba[:, 3] + contrib)[:, None]], 1)


def _march_region(scene, xf: XFTensors, o, d, rid, active, t0, t1, offset,
                  state, sample):
    """March the sample intervals of each active ray's region interval
    [t0, t1] (integrateBrick, exabrick.cu:1116-1185; PROPER_DISTANCE
    path): the grid (offset + i) dt, each interval [t_last, min(t_i,
    t1)] sampled at its midpoint by ``sample``.  Only the rays still
    marching are sampled: each step gathers them and scatters the
    finished back into ``state`` (a list of per-ray tensors), which is
    returned updated."""
    live = torch.nonzero(active & (t1 > t0))[:, 0]
    if live.numel() == 0:
        return state
    state = [s.clone() for s in state]
    o_l, d_l, rid_l, t1_l = o[live], d[live], rid[live], t1[live]
    finest_cw = scene.region_finest_cw[rid_l]
    dt = xf.dt * finest_cw
    t_i = _sample_grid(dt, t0[live], offset[live])
    t_last = t0[live]
    sub = [s[live] for s in state]
    while True:
        t_next = torch.minimum(t_i, t1_l)
        t_sample = 0.5 * (torch.minimum(t1_l, t_next) + t_last)
        pos = o_l + t_sample[:, None] * d_l
        sub, stop = sample(rid_l, d_l, finest_cw, pos, t_sample,
                           t_next - t_last, sub)
        stop = t_next >= t1_l if stop is None else stop | (t_next >= t1_l)
        t_i = t_i + dt
        t_last = t_next
        keep = torch.nonzero(~stop)[:, 0]
        if keep.numel() < live.numel():
            done = torch.nonzero(stop)[:, 0]
            for s, v in zip(state, sub):
                s[live[done]] = v[done]
            if keep.numel() == 0:
                return state
            live, t_i, t_last, dt, o_l, d_l, rid_l, t1_l, finest_cw = (
                x[keep] for x in (live, t_i, t_last, dt, o_l, d_l, rid_l,
                                  t1_l, finest_cw))
            sub = [v[keep] for v in sub]


def bsp_locator(scene):
    """The walk's default point location: the BSP descent
    (``locate_leaf``), returning (region id, leaf box lo, hi)."""
    def locate(p):
        node = locate_leaf(scene, p)
        return scene.tree_leaf[node], scene.tree_lo[node], scene.tree_hi[node]
    return locate


def march_rays(scene, xf: XFTensors, o, d, offset, t_start, t_end,
               act_mask, max_iters: int, state, sample, region_done,
               locate=None):
    """The region walk shared by the DVR and iso marches (the raygen
    loop, exabrick.cu:1662-1699): each voxel-space ray (unit d) is
    clipped to the BSP root box and, up to ``max_iters`` times, locates
    its region at t_cur + eps, clips itself to the leaf box, marches the
    interval if the region is active in ``act_mask`` (``_march_region``
    with the per-sample functor ``sample``) and advances past the box.
    ``locate(points (n, 3)) -> (region id (n,), box lo (n, 3), box hi
    (n, 3))``: the point location (default ``bsp_locator(scene)``; the
    packed walk passes ``wavefront.locate_packed``'s).

    ``state``: per-ray tensors (first dim P), the initial values.
    ``sample(rid, d, finest_cw, pos, t_sample, actual_dt, state) ->
    (state, stop or None)`` integrates one sample; ``region_done(state)
    -> (state, done)`` ends a region iteration.  A ray leaves the walk
    when it is done or past its end; only the rays still walking are
    stepped (gathered by index, the finished scattered back).  Returns
    (state, region iterations (P,) float32)."""
    p = o.shape[0]
    locate = locate or bsp_locator(scene)
    hitb, tb0, tb1 = ray_box_root(scene, o, d, t_start, t_end)
    span = torch.clamp(tb1 - tb0, min=0.0)
    eps = torch.clamp(span * 1e-6, min=1e-5)
    limit = torch.minimum(t_end, tb1)
    t_cur = torch.clamp(tb0, min=0.0)
    out = [s.clone() for s in state]
    iters = torch.zeros(p, dtype=o.dtype, device=o.device)
    live = torch.nonzero(hitb & (t_cur < limit))[:, 0]
    ray = [x[live] for x in (o, d, offset, limit, eps, t_cur)]
    sub = [s[live] for s in out]
    n_it = torch.zeros(live.numel(), dtype=o.dtype, device=o.device)
    for _ in range(max_iters):
        if live.numel() == 0:
            break
        o_l, d_l, off_l, lim, ep, tc = ray
        probe = o_l + torch.minimum(tc + ep, lim)[:, None] * d_l
        rid, box_lo, box_hi = locate(probe)
        hit, t0, t1 = ray_box(o_l, d_l, box_lo, box_hi, tc, lim)
        # a probe that missed (degenerate leaf) steps on by eps
        t1 = torch.where(hit, t1, tc + ep)
        rc = torch.clamp(rid, min=0)
        active = hit & (rid >= 0) & act_mask[rc]
        sub = _march_region(scene, xf, o_l, d_l, rc, active, t0, t1, off_l,
                            sub, sample)
        sub, done = region_done(sub)
        tc = t1 * REGION_ADVANCE_EPS
        ray[5] = tc
        n_it = n_it + 1.0
        done = done | (tc >= lim)
        fin = torch.nonzero(done)[:, 0]
        if fin.numel():
            for s, v in zip(out, sub):
                s[live[fin]] = v[fin]
            iters[live[fin]] = n_it[fin]
            keep = torch.nonzero(~done)[:, 0]
            live, n_it = live[keep], n_it[keep]
            ray = [x[keep] for x in ray]
            sub = [v[keep] for v in sub]
    for s, v in zip(out, sub):
        s[live] = v
    iters[live] = n_it
    return out, iters


def voxel_rays(scene, o_world, d_world):
    """World rays (one eye (3,) or (P, 3) origins) in the scene's voxel
    space: (o (P, 3), unit d (P, 3), the world-to-voxel t scale (P,)),
    float32 on the scene's device."""
    dev = scene.scalars.device
    o_world = torch.as_tensor(o_world, dtype=torch.float32, device=dev)
    d_world = torch.as_tensor(d_world, dtype=torch.float32, device=dev)
    p = d_world.shape[0]
    m = scene.voxel_from_world
    o = _affine_rows(o_world.expand(p, 3), m, True)
    d = _affine_rows(d_world, m, False)
    dt_scale = _norm3(d)
    return o, d / dt_scale[:, None], dt_scale


def march_batches(scene, xf, rays, offset, act_mask, max_iters, state,
                  sample, region_done, batch: int, locate=None):
    """``march_rays`` over the voxel rays (o, d, t_start, t_end) in
    batches of ``batch`` rays; returns the concatenated (state, iters)."""
    o, d, t_start, t_end = rays
    outs = [march_rays(scene, xf, o[i:i + batch], d[i:i + batch],
                       offset[i:i + batch], t_start[i:i + batch],
                       t_end[i:i + batch], act_mask, max_iters,
                       [s[i:i + batch] for s in state], sample, region_done,
                       locate)
            for i in range(0, o.shape[0], batch)]
    return ([torch.cat([s[j] for s, _ in outs]) for j in range(len(state))],
            torch.cat([it for _, it in outs]))


def _dvr_region_done(state):
    """A saturated ray ends as premultiplied opaque
    (exabrick.cu:1694-1697)."""
    rgba, = state
    saturated = rgba[:, 3] >= TERMINATION_THRESHOLD
    rgba = torch.where(
        saturated[:, None],
        torch.cat([rgba[:, :3] * rgba[:, 3:4], torch.ones_like(rgba[:, :1])],
                  1), rgba)
    return [rgba], saturated


def trace_dvr(scene, fs, cfg: RenderConfig, o_world, d_world, offset,
              t_end_world=None, t_start_world=None, return_stats=False,
              batch=None):
    """Volume-integrate a batch of rays (the raygen DVR loop,
    exabrick.cu:1662-1699), on the scene's device.  Returns the
    accumulated rgba (P, 4); with ``return_stats`` also each ray's
    region-iteration count (P,) float32 (the deterministic analog of the
    clock heat map, exabrick.cu:1703-1707).  ``cfg.max_region_iters``
    caps every ray's region iterations.  ``batch``: rays per batch
    (default ``ray_batch`` for the config's sample points)."""
    rays, offset, xf, act_mask = dvr_setup(scene, fs, cfg, o_world, d_world,
                                           offset, t_end_world, t_start_world)
    cd = cfg.gradient_shading_dvr and not (cfg.basis_method
                                           and cfg.analytic_gradients)

    def sample(rid, d_l, finest_cw, pos, _t, actual_dt, st):
        return _march_step(scene, xf, cfg, act_mask, rid, d_l, finest_cw,
                           pos, actual_dt, st)

    (rgba,), iters = march_batches(
        scene, xf, rays, offset, act_mask, cfg.max_region_iters,
        [torch.zeros((offset.shape[0], 4), dtype=torch.float32,
                     device=offset.device)], sample,
        _dvr_region_done, batch or ray_batch(scene, 6 if cd else 1))
    return (rgba, iters) if return_stats else rgba


def dvr_setup(scene, fs, cfg: RenderConfig, o_world, d_world, offset,
              t_end_world=None, t_start_world=None):
    """A DVR march's inputs on the scene's device: the voxel rays (o, d,
    t_start, t_end) (world t scaled to voxel t; [0, 2e10] by default),
    the jitter offsets, the frame's transfer functions and the per-region
    active mask (all ones without space skipping)."""
    dev = scene.scalars.device
    o, d, dt_scale = voxel_rays(scene, o_world, d_world)
    p = o.shape[0]
    t_end = (torch.full((p,), 2e10, dtype=torch.float32, device=dev)
             if t_end_world is None
             else torch.as_tensor(t_end_world, device=dev) * dt_scale)
    t_start = (torch.zeros(p, dtype=torch.float32, device=dev)
               if t_start_world is None
               else torch.as_tensor(t_start_world, device=dev) * dt_scale)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    xf = XFTensors.from_frame(fs, dev)
    if cfg.space_skipping:
        act_mask = region_active_mask(scene, xf, cfg.num_channels)
    else:
        act_mask = torch.ones(scene.region_value_range.shape[0],
                              dtype=torch.bool, device=dev)
    return (o, d, t_start, t_end), offset, xf, act_mask


# ----------------------------------------------------------------------------
# full frame: rays -> rgba -> composite over background -> accumulate
# ----------------------------------------------------------------------------

def generate_rays(fs, width: int, height: int, jitter=None, device="cuda"):
    """Per-pixel rays of the frame state's camera (programs/Camera.h:
    27-44), row-major from the bottom row.  jitter: (P, 2) in [0, 1) or
    None for pixel centers.  Returns (o (P, 3), d (P, 3)) on ``device``."""
    dev = render_device(device)
    px = torch.arange(width, dtype=torch.float32, device=dev).repeat(height)
    py = torch.arange(height, dtype=torch.float32,
                      device=dev).repeat_interleave(width)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[:, 0], jitter[:, 1]

    def f3(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    d = (f3(fs.cam_dir00)[None] + (px + jx)[:, None] * f3(fs.cam_du)[None]
         + (py + jy)[:, None] * f3(fs.cam_dv)[None])
    d = d / _norm3(d)[:, None]
    return f3(fs.cam_pos).expand(d.shape), d


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.0031308, 12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-20), 1 / 2.4) - 0.055)


def composite_background(rgba: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    w = rgba[:, 3:4]
    return w * rgba[:, :3] + (1.0 - w) * bg


def accumulate(color: torch.Tensor, accum: torch.Tensor, frame_id: int):
    """Progressive accumulation (exabrick.cu:1709-1719).  Returns
    (new_accum (P, 4), display color in sRGB (P, 3))."""
    if frame_id > 0:
        color = color + accum[:, :3]
    new_accum = torch.cat([color, torch.ones_like(color[:, :1])], dim=1)
    shown = color / (frame_id + 1.0)
    return new_accum, linear_to_srgb(shown)


def pack_rgba8(color_srgb: torch.Tensor) -> torch.Tensor:
    """(P, 3) float -> (P,) RGBA8 words (int64 holding uint32 values)."""
    c = torch.clamp((color_srgb * 256.0).to(torch.int32), 0, 255).to(
        torch.int64)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | 0xFF000000

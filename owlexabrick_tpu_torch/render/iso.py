"""Implicit iso-surface ray marching on the exact scene (the port of
``owlexabrick_tpu/render/iso.py``: traceIsoRay, exabrick.cu:1408-1460,
and IsoSurfaceIntegrationFunction, exabrick.cu:1018-1114).

The DVR core's region walk (``dvr.march_rays``: BSP point location to
enumerate each ray's region intervals, a sample march inside, the live
rays gathered by index) with a crossing functor in place of the
composite.  Regions are culled by iso activity (an enabled iso value
inside the region's value range, exabrick.cu:373-402) instead of
transfer-function opacity, and a ray leaves the walk after the first
region holding a crossing.

Per ray and channel the previous sample (value, t) is kept; a crossing
of an enabled iso value between consecutive samples is a hit at the
distance-weighted average t.  The reference's quirk is kept: within the
first region holding any crossing, the *first* crossing fixes the color
and the *last* one fixes t_hit and the shading normal.
"""

from __future__ import annotations

import numpy as np
import torch

from .dvr import (
    XFTensors,
    _dot3,
    _norm3,
    gradient_cd,
    march_batches,
    ray_batch,
    ray_box_root,  # noqa: F401  (the JAX module's name for the root clip)
    sample_basis,
    voxel_rays,
)

_NO_VALUE = -1e36  # "no previous sample" (>= -1e35 means one exists)


def _enabled_isos(fs):
    """(float32 value, channel) of each enabled iso surface."""
    return [(float(np.float32(fs.iso_value[i])), int(fs.iso_channel[i]))
            for i in range(len(fs.iso_enabled)) if bool(fs.iso_enabled[i])]


def iso_region_mask(scene, fs):
    """(N,) bool: the region's value range holds an enabled iso value."""
    vr = scene.region_value_range
    m = torch.zeros(vr.shape[0], dtype=torch.bool, device=vr.device)
    for iso, _ in _enabled_isos(fs):
        m = m | ((iso >= vr[:, 0]) & (iso <= vr[:, 1]))
    return m


def _shade_crossing(scene, xf, cfg, rid, isopt, d, c: int, act_mask):
    """Color (shaded, (n, 3)) and face-forward unit normal (n, 3) of
    crossings at isopt (exabrick.cu:1058-1098)."""
    if cfg.gradient_shading_iso:
        if cfg.analytic_gradients:
            rok, rval, grad = sample_basis(scene, rid, isopt, c, True)
        else:
            # gradientCD<ISO=true>: relocating through the iso-culled BSP
            # (exabrick.cu:860-866, 924)
            rok, rval = sample_basis(scene, rid, isopt, c)
            fcw = scene.region_finest_cw[rid]
            grad = gradient_cd(scene, isopt, c, (fcw + 1.0) * 0.5, True,
                               act_mask,
                               rid if cfg.fast_central_differences else None)
        gl = _norm3(grad)[:, None]
        g = grad / torch.clamp(gl, min=1e-20)
        g = torch.where((_dot3(g, d) > 0)[:, None], -g, g)
        g = torch.where(torch.isfinite(g).all(-1, keepdim=True), g, 0.0)
        g = torch.where(gl > 0, g, 0.0)
    else:
        rok, rval = sample_basis(scene, rid, isopt, c)
        g = torch.zeros_like(isopt)
    samp = xf.lookup(c, rval)
    red = torch.zeros_like(samp[:, :3])
    red[:, 0] = 1.0
    rgb = torch.where(rok[:, None], samp[:, :3], red)
    if cfg.colormap_channel != 0:
        cok, cval = sample_basis(scene, rid, isopt, cfg.colormap_channel)
        rgb = torch.where(cok[:, None], xf.lookup(0, cval)[:, :3], rgb)
    glen = _norm3(g)
    shade = 0.3 + 0.7 * _dot3(-d, g).abs() / torch.clamp(glen, min=1e-20)
    return torch.where((glen > 0.0)[:, None], rgb * shade[:, None], rgb), g


def _detect_crossings(scene, fs, xf, cfg, rid, pos, t_sample, last_val,
                      last_t, found, t_hit, color, normal, d, act_mask=None):
    """One sample step of every channel's integration functor for the
    given (marching) rays.  Crossing points are resampled and shaded only
    where a crossing is (the lockstep march computes them everywhere and
    keeps them there).  Returns the updated (last_val, last_t, found,
    t_hit, color, normal)."""
    last_val, last_t = last_val.clone(), last_t.clone()
    isos = _enabled_isos(fs)
    for c in range(cfg.num_channels):
        ok, value = sample_basis(scene, rid, pos, c)
        prev_v = last_val[:, c]
        prev_t = last_t[:, c]
        have_prev = prev_v >= -1e35
        for iso, ch in isos:
            if ch != c:
                continue
            crossing = (ok & have_prev
                        & (((prev_v <= iso) & (value >= iso))
                           | ((prev_v >= iso) & (value <= iso))))
            at = torch.nonzero(crossing)[:, 0]
            if at.numel() == 0:
                continue
            d1 = (prev_v[at] - iso).abs()
            d2 = (value[at] - iso).abs()
            denom = torch.where(d1 + d2 > 0, d1 + d2, 1.0)
            w1 = 1.0 - d1 / denom
            w2 = 1.0 - d2 / denom
            ts = t_sample[at]
            tavg = prev_t[at] * w1 + ts * w2
            isopt = pos[at] + (tavg - ts)[:, None] * d[at]
            rgb, g = _shade_crossing(scene, xf, cfg, rid[at], isopt, d[at],
                                     c, act_mask)
            first = ~found[at]
            color = color.clone()
            color[at] = torch.where(first[:, None], rgb, color[at])
            t_hit = t_hit.clone()
            t_hit[at] = tavg
            normal = normal.clone()
            normal[at] = g
            found = found | crossing
        last_val[:, c] = torch.where(ok, value, prev_v)
        last_t[:, c] = torch.where(ok, t_sample, prev_t)
    return last_val, last_t, found, t_hit, color, normal


def trace_iso_rays(scene, fs, cfg, o_world, d_world, tmin_world,
                   tmax_world, batch=None):
    """The nearest iso-surface hit of each world ray over [tmin, tmax]
    (world t), through the DVR core's region walk (``dvr.march_rays``)
    with this module's crossing functor and no jitter offset.  Returns
    (t_hit_world (P,), normal (P, 3), color (P, 3)): t inf, normal and
    color 0 where nothing is hit.  ``batch``: rays per batch (default
    ``ray_batch`` for the config's crossing-normal sample points)."""
    dev = scene.scalars.device
    o, d, dt_scale = voxel_rays(scene, o_world, d_world)
    p = o.shape[0]
    tmin = torch.as_tensor(tmin_world, device=dev) * dt_scale
    t_end = torch.as_tensor(tmax_world, device=dev) * dt_scale
    xf = XFTensors.from_frame(fs, dev)
    act = iso_region_mask(scene, fs)
    c = cfg.num_channels
    f32 = dict(dtype=torch.float32, device=dev)
    state = [torch.full((p, c), _NO_VALUE, **f32), torch.zeros((p, c), **f32),
             torch.zeros(p, dtype=torch.bool, device=dev),
             torch.full((p,), float("inf"), **f32), torch.zeros((p, 3), **f32),
             torch.zeros((p, 3), **f32)]

    def sample(rid, d_l, _fcw, pos, t_sample, _dt, st):
        return list(_detect_crossings(scene, fs, xf, cfg, rid, pos, t_sample,
                                      *st, d_l, act)), None

    cd = cfg.gradient_shading_iso and not cfg.analytic_gradients
    (_, _, found, t_hit, color, normal), _ = march_batches(
        scene, xf, (o, d, tmin, t_end), torch.zeros(p, **f32), act,
        cfg.max_region_iters, state, sample, lambda st: (st, st[2]),
        batch or ray_batch(scene, 6 if cd else 1))
    t_hit_world = torch.where(found, t_hit / dt_scale, float("inf"))
    return t_hit_world, normal, color

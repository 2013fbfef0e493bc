"""Scalar numpy oracle (the port of ``owlexabrick_tpu/oracle/reference.py``):
a literal, slow re-statement of the reference's device formulas
(programs/exabrick.cu) used as the golden model in tests.

It shares no code with the renderer: the production path
(``render/dvr.py``) is batched torch over a BSP tree, the oracle is
per-pixel Python over brute-force region enumeration.  Agreement between
the two is the correctness argument.  Every public function takes the
port's ``Scene`` (torch tensors on any device) and first brings its
tables to the host as numpy arrays; the formulas are the JAX package's,
unchanged.

Formula sources:
  * basis accumulation      exabrick.cu:620-777  (addBasisFunctions)
  * point sampling          exabrick.cu:781-816  (samplePoint)
  * analytic gradients      exabrick.cu:883-942
  * XF lookup               exabrick.cu:136-150
  * DVR compositing         exabrick.cu:988-1016 (integrateVolume)
  * in-region marching      exabrick.cu:1116-1185 (integrateBrick)
  * iso-surface detection   exabrick.cu:1018-1114, 1187-1256
  * raygen main loop        exabrick.cu:1576-1720
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np

from ..core.constants import (
    NUM_XF_VALUES,
    EMPTY_CELL_POISON_VALUE,
    REGION_ADVANCE_EPS,
    TERMINATION_THRESHOLD,
)


class _HostScene(types.SimpleNamespace):
    """A Scene's fields as host numpy arrays (ints stay ints)."""


def _host(scene):
    """``scene``'s tables on the host: each tensor through
    ``.cpu().numpy()``; a host scene passes through."""
    if isinstance(scene, _HostScene):
        return scene
    fields = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        fields[f.name] = v.cpu().numpy() if hasattr(v, "cpu") else v
    return _HostScene(**fields)


def lookup_xf_scalar(lut: np.ndarray, lo: float, hi: float,
                     opacity_scale: float, v: float) -> np.ndarray:
    n = lut.shape[0]
    scalar = (n - 1) * (v - lo) / ((hi - lo) + 1e-20)
    scalar = min(max(scalar + 0.5, 0.0), n - 1.0)
    scalar /= n - 1.0
    u = scalar * n - 0.5
    i0 = math.floor(u)
    frac = u - i0
    i0c = min(max(i0, 0), n - 1)
    i1c = min(max(i0 + 1, 0), n - 1)
    rgba = lut[i0c] * (1.0 - frac) + lut[i1c] * frac
    rgba = rgba.copy()
    rgba[3] *= opacity_scale
    return rgba


def add_basis_functions(scene, brick_id: int, pos: np.ndarray, channel: int,
                        need_derivative: bool = False,
                        allow_empty_cells: bool = False):
    """Returns (sum_weighted_values, sum_weights, sum_derivs, sum_deriv_coeffs).

    ``allow_empty_cells``: ALLOW_EMPTY_CELLS parity (CMakeLists.txt:73,
    OFF by default like the reference) — corners whose scalar equals
    EMPTY_CELL_POISON_VALUE contribute neither weight nor value
    (notEmptyCell, exabrick.cu:614-618)."""
    scene = _host(scene)
    lower = scene.brick_lower[brick_id]
    size = scene.brick_size[brick_id]
    cw = float(scene.brick_cell_width[brick_id])
    begin = int(scene.brick_begin[brick_id])

    local = (pos - lower) / cw - 0.5
    idx_lo = np.maximum(np.floor(local).astype(np.int64), -1)
    frac = local - idx_lo
    neg = 1.0 - frac

    swv = 0.0
    sw = 0.0
    sd = np.zeros(3)
    sdc = np.zeros(3)
    for dz in (0, 1):
        iz = idx_lo[2] + dz
        if iz < 0 or iz >= size[2]:
            continue
        wz = frac[2] if dz else neg[2]
        for dy in (0, 1):
            iy = idx_lo[1] + dy
            if iy < 0 or iy >= size[1]:
                continue
            wy = frac[1] if dy else neg[1]
            for dx in (0, 1):
                ix = idx_lo[0] + dx
                if ix < 0 or ix >= size[0]:
                    continue
                wx = frac[0] if dx else neg[0]
                s = float(
                    scene.scalars[channel, begin + ix + size[0] * (iy + size[1] * iz)]
                )
                # scalars are stored float32: compare at f32 precision
                # (the reference's compare is float == float)
                if allow_empty_cells and np.float32(s) == np.float32(
                    EMPTY_CELL_POISON_VALUE
                ):
                    continue
                w = wz * wy * wx
                sw += w
                swv += w * s
                if need_derivative:
                    gx = wz * wy * (1.0 if dx else -1.0)
                    gy = wz * wx * (1.0 if dy else -1.0)
                    gz = wy * wx * (1.0 if dz else -1.0)
                    g = np.array([gx, gy, gz])
                    sdc += g
                    sd += g * s
    return swv, sw, sd, sdc


def sample_point_nearest(scene, region_id: int, pos: np.ndarray, channel: int):
    """Non-basis nearest-cell sampling (exabrick.cu:807-815); the region
    holds exactly one brick in this mode."""
    scene = _host(scene)
    b = int(scene.region_bricks[region_id][0])
    lower = scene.brick_lower[b]
    size = scene.brick_size[b]
    cw = float(scene.brick_cell_width[b])
    begin = int(scene.brick_begin[b])
    idx = np.clip(
        np.floor((np.asarray(pos) - lower) / cw).astype(int), 0, size - 1
    )
    lin = begin + idx[0] + size[0] * (idx[1] + size[1] * idx[2])
    return True, float(scene.scalars[channel, lin])


def sample_point(scene, region_id: int, pos: np.ndarray, channel: int,
                 allow_empty_cells: bool = False):
    """Basis-weighted sample over the region's brick list; returns
    (ok, value)."""
    scene = _host(scene)
    swv = 0.0
    sw = 0.0
    for b in scene.region_bricks[region_id]:
        if b < 0:
            continue
        v, w, _, _ = add_basis_functions(
            scene, int(b), pos, channel,
            allow_empty_cells=allow_empty_cells)
        swv += v
        sw += w
    if sw <= 1e-20:
        return False, 0.0
    return True, swv / sw


def sample_point_with_derivative(scene, region_id: int, pos: np.ndarray,
                                 channel: int,
                                 allow_empty_cells: bool = False):
    scene = _host(scene)
    swv = 0.0
    sw = 0.0
    sd = np.zeros(3)
    sdc = np.zeros(3)
    for b in scene.region_bricks[region_id]:
        if b < 0:
            continue
        v, w, d, dc = add_basis_functions(
            scene, int(b), pos, channel, True,
            allow_empty_cells=allow_empty_cells)
        swv += v
        sw += w
        sd += d
        sdc += dc
    if sw <= 1e-20:
        return False, 0.0, np.zeros(3)
    # quotient-rule numerator only (exabrick.cu:916-921)
    grad = sw * sd - swv * sdc
    return True, swv / sw, grad


def locate_region_point(scene, pos: np.ndarray) -> int:
    """Region containing a point; boundary points belong to the upper
    region (the BSP's `p >= split -> right` rule)."""
    scene = _host(scene)
    for i in range(scene.region_lo.shape[0]):
        if np.all(pos >= scene.region_lo[i]) and np.all(
            pos < scene.region_hi[i]
        ):
            return i
    return -1


def gradient_cd(scene, pos: np.ndarray, channel: int, delta: float,
                basis_method: bool = True, active_check=None,
                fixed_region: int = -1, allow_empty_cells: bool = False):
    """Central differences (gradientCD, exabrick.cu:832-880): per-offset
    relocation by default; ``fixed_region`` >= 0 keeps samples in the
    caller's region (FAST_CENTRAL_DIFFERENCES=ON, exabrick.cu:850-852).
    Offsets that land outside the domain or in a BVH-culled region sample
    0; returns s[1]-s[0], i.e. f(pos-δe_i) - f(pos+δe_i) per axis."""
    scene = _host(scene)
    g = np.zeros(3)
    for i in range(3):
        s = [0.0, 0.0]
        for j, sgn in enumerate((1.0, -1.0)):
            q = np.asarray(pos, np.float64).copy()
            q[i] += sgn * delta
            if fixed_region >= 0:
                rid = fixed_region
            else:
                rid = locate_region_point(scene, q)
                if rid >= 0 and active_check is not None \
                        and not active_check(rid):
                    rid = -1
            if rid >= 0:
                if basis_method:
                    ok, v = sample_point(
                        scene, rid, q, channel,
                        allow_empty_cells=allow_empty_cells)
                else:
                    ok, v = sample_point_nearest(scene, rid, q, channel)
                if ok:
                    s[j] = v
        g[i] = s[1] - s[0]
    return g


def box_test(o, d, lo, hi, tmin, tmax):
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo = (lo - o) / d
        t_hi = (hi - o) / d
    t_nr = np.minimum(t_lo, t_hi)
    t_fr = np.maximum(t_lo, t_hi)
    t0 = max(tmin, np.max(t_nr))
    t1 = min(tmax, np.min(t_fr))
    return (t0 < t1), t0, t1


def region_active(scene, fs, region_id: int, num_channels: int) -> bool:
    """activeForVolumeSampling over all channels (exabrick.cu:250-304)."""
    scene = _host(scene)
    vr = scene.region_value_range[region_id]
    for c in range(num_channels):
        lo, hi = float(fs.xf_domain[c][0]), float(fs.xf_domain[c][1])
        if vr[0] > hi or vr[1] < lo:
            continue
        scaled_lo = (vr[0] - lo) / ((hi - lo) + 1e-20)
        scaled_hi = (vr[1] - lo) / ((hi - lo) + 1e-20)
        n = NUM_XF_VALUES
        idx_lo = min(max(int(scaled_lo * (n - 1)), 0), n - 1)
        idx_hi = min(max(int(scaled_hi * (n - 1)) + 1, 0), n - 1)
        for i in range(idx_lo, idx_hi + 1):
            cell_value = i / (n - 1) * (hi - lo) + lo
            rgba = lookup_xf_scalar(
                np.asarray(fs.xf_lut[c]), lo, hi,
                float(fs.xf_opacity_scale), cell_value
            )
            if rgba[3] > 0.0:
                return True
    return False


def integrate_brick(scene, fs, pixel_color: np.ndarray, offset: float,
                    o, d, region_id: int, t0: float, t1: float,
                    num_channels: int, gradient_shading: bool,
                    basis_method: bool = True,
                    analytic_gradients: bool = True,
                    allow_empty_cells: bool = False):
    """Front-to-back march of one region interval (exabrick.cu:1116-1185,
    PROPER_DISTANCE_IN_OPACITY_CORRECTION path)."""
    scene = _host(scene)
    global_dt = float(fs.dt)
    finest_cw = float(scene.region_finest_cw[region_id])
    dt = global_dt * finest_cw

    i0 = int(math.ceil((t0 - dt * offset) / dt))
    t_i = (offset + i0) * dt
    while (t_i - dt) >= t0:
        t_i -= dt
    while t_i < t0:
        t_i += dt

    t_last = t0
    while True:
        t_next = min(t_i, t1)
        t_sample = 0.5 * (min(t1, t_next) + t_last)
        actual_dt = t_next - t_last
        t_last = t_next

        pos = o + t_sample * d
        for c in range(num_channels):
            act = lambda r: region_active(scene, fs, r, num_channels)
            if not basis_method:
                ok, value = sample_point_nearest(scene, region_id, pos, c)
                if gradient_shading:
                    # delta = (brick.level+1)/2 (exabrick.cu:938)
                    lvl = math.log2(finest_cw)
                    grad = gradient_cd(scene, pos, c, (lvl + 1.0) * 0.5,
                                       False, act)
                else:
                    grad = np.zeros(3)
            elif gradient_shading and not analytic_gradients:
                ok, value = sample_point(
                    scene, region_id, pos, c,
                    allow_empty_cells=allow_empty_cells)
                # delta = (finestLevelCellWidth+1)/2 (exabrick.cu:924)
                grad = gradient_cd(scene, pos, c, (finest_cw + 1.0) * 0.5,
                                   True, act)
            elif gradient_shading:
                ok, value, grad = sample_point_with_derivative(
                    scene, region_id, pos, c,
                    allow_empty_cells=allow_empty_cells,
                )
            else:
                ok, value = sample_point(
                    scene, region_id, pos, c,
                    allow_empty_cells=allow_empty_cells)
                grad = np.zeros(3)
            if ok and actual_dt != 0.0:
                sample = lookup_xf_scalar(
                    np.asarray(fs.xf_lut[c]),
                    float(fs.xf_domain[c][0]), float(fs.xf_domain[c][1]),
                    float(fs.xf_opacity_scale), value,
                )
                if np.linalg.norm(grad) > finest_cw * 1e-6:
                    light = -d
                    scale = abs(light @ grad) / math.sqrt(
                        (grad @ grad) * (light @ light)
                    )
                    sample[:3] *= scale
                a = 1.0 - (1.0 - sample[3]) ** actual_dt
                pixel_color[:3] += (1.0 - pixel_color[3]) * a * sample[:3]
                pixel_color[3] += (1.0 - pixel_color[3]) * a
        if pixel_color[3] >= TERMINATION_THRESHOLD:
            break
        if t_next >= t1:
            break
        t_i += dt
    return pixel_color


def _enumerate_region_hit(scene, fs, o, d, tmin, tmax, num_channels,
                          require_active=True):
    """Brute-force stand-in for the volume BVH: closest active region the
    ray overlaps in [tmin, tmax]."""
    best = (-1, 0.0, 0.0)
    best_t0 = np.inf
    n = scene.region_lo.shape[0]
    for rid in range(n):
        hit, t0, t1 = box_test(
            o, d, scene.region_lo[rid], scene.region_hi[rid], tmin, tmax
        )
        if not hit or t0 >= best_t0:
            continue
        if require_active and not region_active(scene, fs, rid, num_channels):
            continue
        best = (rid, t0, t1)
        best_t0 = t0
    return best


def trace_dvr_ray(scene, fs, o_world, d_world, num_channels: int = 1,
                  offset: float = 0.0, t_world_max: float = 2e10,
                  space_skipping: bool = True,
                  gradient_shading: bool = False,
                  basis_method: bool = True,
                  analytic_gradients: bool = True,
                  allow_empty_cells: bool = False) -> np.ndarray:
    """Full DVR path of one ray (raygen main loop, exabrick.cu:1662-1699).
    Returns accumulated RGBA (premultiplied by nothing; .w is opacity)."""
    scene = _host(scene)
    m = np.asarray(scene.voxel_from_world, np.float64)
    o = m[:, :3] @ np.asarray(o_world, np.float64) + m[:, 3]
    d = m[:, :3] @ np.asarray(d_world, np.float64)
    dt_scale = float(np.linalg.norm(d))
    d = d / dt_scale

    pixel_color = np.zeros(4)
    already = dt_scale * 0.0
    while True:
        rid, t0, t1 = _enumerate_region_hit(
            scene, fs, o, d, already, t_world_max * dt_scale, num_channels,
            require_active=space_skipping,
        )
        if rid < 0:
            break
        integrate_brick(
            scene, fs, pixel_color, offset, o, d, rid, t0, t1,
            num_channels, gradient_shading, basis_method,
            analytic_gradients, allow_empty_cells,
        )
        if pixel_color[3] >= TERMINATION_THRESHOLD:
            pixel_color = np.array(
                [*(pixel_color[:3] * pixel_color[3]), 1.0]
            )
            break
        already = t1 * REGION_ADVANCE_EPS
    return pixel_color


def _iso_region_active(scene, fs, region_id: int) -> bool:
    vr = scene.region_value_range[region_id]
    for i in range(len(fs.iso_enabled)):
        if (
            fs.iso_enabled[i]
            and vr[0] <= float(fs.iso_value[i]) <= vr[1]
        ):
            return True
    return False


def trace_iso_ray(scene, fs, o_world, d_world, num_channels: int = 1,
                  gradient_shading_iso: bool = True,
                  colormap_channel: int = 0,
                  analytic_gradients: bool = True):
    """Scalar iso-surface march (traceIsoRay + the integration functor,
    exabrick.cu:1408-1460, 1018-1114).  Returns (t_hit_world, normal,
    color) or (inf, 0, 0) on miss.  Reference quirk preserved: within the
    first region containing a crossing, the first crossing sets the color
    and the last crossing sets t_hit and the normal."""
    scene = _host(scene)
    m = np.asarray(scene.voxel_from_world, np.float64)
    o = m[:, :3] @ np.asarray(o_world, np.float64) + m[:, 3]
    d = m[:, :3] @ np.asarray(d_world, np.float64)
    dt_scale = float(np.linalg.norm(d))
    d = d / dt_scale

    last_val = np.full(num_channels, -1e36)
    last_t = np.zeros(num_channels)
    already = 0.0
    found = False
    t_hit = np.inf
    color = np.zeros(3)
    normal = np.zeros(3)

    while True:
        best = (-1, 0.0, 0.0)
        best_t0 = np.inf
        for rid in range(scene.region_lo.shape[0]):
            hit, t0, t1 = box_test(
                o, d, scene.region_lo[rid], scene.region_hi[rid],
                already, 2e10,
            )
            if not hit or t0 >= best_t0:
                continue
            if not _iso_region_active(scene, fs, rid):
                continue
            best = (rid, t0, t1)
            best_t0 = t0
        rid, t0, t1 = best
        if rid < 0:
            break

        finest_cw = float(scene.region_finest_cw[rid])
        dt = float(fs.dt) * finest_cw
        i0 = math.ceil(t0 / dt)
        t_i = i0 * dt
        while (t_i - dt) >= t0:
            t_i -= dt
        while t_i < t0:
            t_i += dt
        t_last = t0
        while True:
            t_next = min(t_i, t1)
            t_sample = 0.5 * (min(t1, t_next) + t_last)
            t_last = t_next
            pos = o + t_sample * d
            for c in range(num_channels):
                ok, value = sample_point(scene, rid, pos, c)
                if ok:
                    prev_v = last_val[c]
                    prev_t = last_t[c]
                    if prev_v >= -1e35:
                        for i in range(len(fs.iso_enabled)):
                            if not fs.iso_enabled[i]:
                                continue
                            if int(fs.iso_channel[i]) != c:
                                continue
                            iso = float(fs.iso_value[i])
                            if not (
                                (prev_v <= iso <= value)
                                or (value <= iso <= prev_v)
                            ):
                                continue
                            d1 = abs(prev_v - iso)
                            d2 = abs(value - iso)
                            denom = (d1 + d2) if (d1 + d2) > 0 else 1.0
                            w1 = 1.0 - d1 / denom
                            w2 = 1.0 - d2 / denom
                            tavg = prev_t * w1 + t_sample * w2
                            isopt = o + tavg * d
                            g = np.zeros(3)
                            rgb = np.array([1.0, 0.0, 0.0])
                            if gradient_shading_iso:
                                if analytic_gradients:
                                    rok, rval, grad = (
                                        sample_point_with_derivative(
                                            scene, rid, isopt, c
                                        )
                                    )
                                else:
                                    # gradientCD<true>: relocation through
                                    # the iso-culled BVH (exabrick.cu:860)
                                    rok, rval = sample_point(
                                        scene, rid, isopt, c
                                    )
                                    fcw = float(
                                        scene.region_finest_cw[rid]
                                    )
                                    grad = gradient_cd(
                                        scene, isopt, c, (fcw + 1.0) * 0.5,
                                        True,
                                        lambda r: _iso_region_active(
                                            scene, fs, r
                                        ),
                                    )
                                if rok:
                                    rgb = lookup_xf_scalar(
                                        np.asarray(fs.xf_lut[c]),
                                        float(fs.xf_domain[c][0]),
                                        float(fs.xf_domain[c][1]),
                                        float(fs.xf_opacity_scale), rval,
                                    )[:3]
                                    gl = np.linalg.norm(grad)
                                    if gl > 0:
                                        g = grad / gl
                                        if g @ d > 0:
                                            g = -g
                                    if not np.isfinite(g).all():
                                        g = np.zeros(3)
                            else:
                                rok, rval = sample_point(
                                    scene, rid, isopt, c
                                )
                                if rok:
                                    rgb = lookup_xf_scalar(
                                        np.asarray(fs.xf_lut[c]),
                                        float(fs.xf_domain[c][0]),
                                        float(fs.xf_domain[c][1]),
                                        float(fs.xf_opacity_scale), rval,
                                    )[:3]
                            if colormap_channel != 0:
                                cok, cval = sample_point(
                                    scene, rid, isopt, colormap_channel
                                )
                                if cok:
                                    rgb = lookup_xf_scalar(
                                        np.asarray(fs.xf_lut[0]),
                                        float(fs.xf_domain[0][0]),
                                        float(fs.xf_domain[0][1]),
                                        float(fs.xf_opacity_scale), cval,
                                    )[:3]
                            gl = np.linalg.norm(g)
                            if gl > 0:
                                shade = 0.3 + 0.7 * abs(-d @ g) / gl
                                rgb = rgb * shade
                            if not found:
                                color = rgb
                            t_hit = tavg
                            normal = g
                            found = True
                    last_val[c] = value
                    last_t[c] = t_sample
            if t_next >= t1:
                break
            t_i += dt
        if found:
            return t_hit / dt_scale, normal, color
        already = t1 * REGION_ADVANCE_EPS
    return np.inf, np.zeros(3), np.zeros(3)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)

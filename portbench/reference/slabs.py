"""The slab sweep of one frame on the megakernel lane (frozen copy of the
port's ``render/slabs.py``: ``render_slabs_camera`` and ``render_slabs``
without the camera-product cache, the einsum lane, the iso sweep or a
surface stop, with K6's plain twin ``xresample_mids_reference``).  Plain
torch; the host-side tables are numpy, as in the port, so both derive
the same integers and knots."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .camera import permute_camera, separable_mapping
from .grids import LevelGrids, crop_grids_y, rnd
from .sweep import (combine_activity, pack_luts, prepare_chunk,
                    sweep_chunk_reference, tile_shape)
from .xf import NUM_XF_VALUES, active_for_volume_sampling, compress_pwl

TERMINATION_THRESHOLD = 0.98


@dataclass(frozen=True)
class SlabConfig:
    """The slab-sweep settings the Renderer's fast path sets (the port's
    ``SlabConfig`` defaults for the rest)."""

    num_channels: int = 1
    nslabs: int = 128
    saturate_collapse: bool = True
    xf_compress: bool = True
    chunk: int = 12
    flip: bool = False
    space_skipping: bool = True
    xf_knots: int = NUM_XF_VALUES
    xf_fit_quantum: float = 1.0
    tile_rows: int = 0
    tile_cols: int = 0
    chunk_budget_mb: int = 7
    adaptive_stride: bool = False


def _ray_rows(d00, cam_dv, height: int, lattice):
    if lattice is not None:
        return np.asarray(lattice[1], np.float64)
    dv1 = float(np.asarray(cam_dv, np.float64)[1])
    return d00[1] + (np.arange(height) + 0.5) * dv1


def y_crop_for_camera(grids: LevelGrids, cfg: SlabConfig, cam_pos,
                      cam_dir00, cam_dv, height: int, lattice=None):
    """Per-level y crop (c0, rows) covering every row the render's rays
    reach; None when no level saves >= 25%."""
    pos = np.asarray(cam_pos, np.float64)
    d00 = np.asarray(cam_dir00, np.float64)
    rz = float(d00[0])
    if rz == 0.0:
        return None
    ry = _ray_rows(d00, cam_dv, height, lattice)
    z_lo, z_hi = float(grids.bounds_lo[0]), float(grids.bounds_hi[0])
    oz, oy = float(pos[0]), float(pos[1])
    dzs = (z_hi - z_lo) / max(cfg.nslabs, 1)
    s_ends = [(z_lo + 0.5 * dzs - oz) / rz, (z_hi - 0.5 * dzs - oz) / rz]
    ys = [oy + s * r for s in s_ends
          for r in (float(ry.min()), float(ry.max()))]
    ymin, ymax = min(ys), max(ys)
    crops = []
    engaged = False
    for li, L in enumerate(grids.levels):
        cw = float(1 << L)
        ny = int(grids.masks[li].shape[1])
        org_y = float(np.float64(grids.origins[li][1]))
        q0 = ymin / cw - org_y - 0.5
        q1 = ymax / cw - org_y - 0.5
        c0 = int(np.floor(q0)) - 2
        c1 = int(np.ceil(q1)) + 3
        bin_ = int(grids.y_bin[li]) if grids.y_bin else 1
        al = math.lcm(8, max(bin_, 1))
        c0 = max(0, (c0 // al) * al)
        c1 = min(ny, max(c1, c0 + 1))
        rows = min(ny - c0, -(-(c1 - c0) // 16) * 16)
        if rows <= 0:
            c0, rows = 0, min(ny, 16)
        crops.append((c0, rows))
        if 4 * rows <= 3 * ny:
            engaged = True
    return tuple(crops) if engaged else None


def ky_hints_for_camera(grids: LevelGrids, cfg: SlabConfig, cam_pos,
                        cam_dir00, cam_dv, height: int, width: int,
                        lattice=None):
    """Per-level y-window row counts (they feed the chunk-depth rule)."""
    pos = np.asarray(cam_pos, np.float64)
    d00 = np.asarray(cam_dir00, np.float64)
    rz = float(d00[0])
    if rz == 0.0:
        return None
    ry = _ray_rows(d00, cam_dv, height, lattice)
    z_lo, z_hi = float(grids.bounds_lo[0]), float(grids.bounds_hi[0])
    oz = float(pos[0])
    scale_max = max(abs(z_lo - oz), abs(z_hi - oz)) / abs(rz)
    tr, _ = tile_shape(height, width, (cfg.tile_rows, cfg.tile_cols))
    n_rt = -(-height // tr)
    ry_p = np.concatenate([ry, np.repeat(ry[-1:], n_rt * tr - height)])
    spans = ry_p.reshape(n_rt, tr)
    ry_span = float((spans.max(1) - spans.min(1)).max())
    dzs = (z_hi - z_lo) / max(cfg.nslabs, 1)
    dscale = cfg.chunk * dzs / abs(rz)
    ry_absmax = float(np.abs(ry).max())
    hints = []
    for L in grids.levels:
        cw = float(1 << L)
        need = (ry_span * scale_max + dscale * ry_absmax) / cw + 5.0
        hints.append(int(-(-int(np.ceil(need)) // 16)) * 16)
    return tuple(hints)


def effective_chunk(grids: LevelGrids, cfg: SlabConfig, height: int,
                    width: int, ky_hints) -> int:
    """Slabs per chunk (part of the quadrature: adaptive-stride groups
    form inside a chunk and the early exit falls between chunks)."""
    def rows_resident(li, m):
        ny8 = -(-int(m.shape[1]) // 8) * 8
        if ky_hints is None:
            return ny8
        return min(int(ky_hints[li]) + 8, ny8)

    ny_total = sum(rows_resident(li, m) for li, m in enumerate(grids.masks))
    tc_est = cfg.tile_cols or next(
        (t for t in (512, 256, 128) if width % t == 0), 128)
    budget = cfg.chunk_budget_mb * 1024 * 1024
    per_slab_bytes = (1 + cfg.num_channels) * ny_total * tc_est * 4
    cap = max(4, budget // (per_slab_bytes * 2))
    return min(cfg.chunk, cap)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


def ray_components(cam_dir00, cam_du, cam_dv, width: int, height: int,
                   device, lattice=None):
    """rx (W,), ry (H,) and sec (H, W) = |r| / |rz|."""
    d00 = np.asarray(cam_dir00, np.float32)
    if lattice is None:
        i_ = torch.arange(width, dtype=torch.float32) + 0.5
        j_ = torch.arange(height, dtype=torch.float32) + 0.5
        rx = _f32(d00[2], "cpu") + i_ * _f32(np.asarray(cam_du)[2], "cpu")
        ry = _f32(d00[1], "cpu") + j_ * _f32(np.asarray(cam_dv)[1], "cpu")
    else:
        rx, ry = (torch.from_numpy(np.ascontiguousarray(l, np.float32))
                  for l in lattice)
    rx, ry = rx.to(device), ry.to(device)
    rz = _f32(d00[0], device)
    sec = torch.sqrt(ry[:, None] * ry[:, None] + rx[None, :] * rx[None, :]
                     + rz * rz) / torch.abs(rz)
    return rx, ry, sec.contiguous()


def slab_spacing(grids: LevelGrids, nslabs: int) -> np.float32:
    z_lo = np.float32(grids.bounds_lo[0])
    z_hi = np.float32(grids.bounds_hi[0])
    return np.float32((z_hi - z_lo) / np.float32(nslabs))


def scaled_luts(fs, num_channels: int):
    """Per-channel (N, 4) LUTs with the opacity scale folded into
    alpha."""
    scale = np.float32(fs.xf_opacity_scale)
    lut = np.asarray(fs.xf_lut, np.float32)
    return [np.concatenate([lut[c, :, :3], lut[c, :, 3:4] * scale], axis=1)
            for c in range(num_channels)]


def _level_occupancy(grids: LevelGrids, z_planes: torch.Tensor):
    lvl_occ = []
    for li, L in enumerate(grids.levels):
        cw = float(1 << L)
        occz = grids.masks[li].amax(dim=(1, 2)).cpu()
        nz = occz.shape[0]
        qz = z_planes / cw - _f32(grids.origins[li][0], "cpu") - 0.5
        k0 = torch.floor(qz).to(torch.int64)
        o0 = torch.where((k0 >= 0) & (k0 < nz),
                         occz[torch.clamp(k0, 0, nz - 1)], 0.0)
        o1 = torch.where((k0 + 1 >= 0) & (k0 + 1 < nz),
                         occz[torch.clamp(k0 + 1, 0, nz - 1)], 0.0)
        lvl_occ.append((o0 + o1) > 0.0)
    return lvl_occ


def tent_taps(q: torch.Tensor, n: int):
    """The two lattice points floor(q), floor(q) + 1 and their tent
    weights (0 outside [0, n))."""
    kf = torch.floor(q)
    k0 = kf.to(torch.int64)
    in0 = (k0 >= 0) & (k0 < n)
    in1 = (k0 + 1 >= 0) & (k0 + 1 < n)
    w0 = torch.where(in0, torch.clamp(1.0 - torch.abs(q - kf), min=0.0), 0.0)
    w1 = torch.where(in1, torch.clamp(1.0 - torch.abs(q - (kf + 1.0)),
                                      min=0.0), 0.0)
    return ((torch.clamp(k0, 0, n - 1), torch.clamp(k0 + 1, 0, n - 1)),
            (w0, w1))


def xresample_mids_reference(zvs: torch.Tensor,
                             qx: torch.Tensor) -> torch.Tensor:
    """K6's plain twin: zvs (C+1, S, ny, nx), qx (S, W) -> (C+1, S, ny,
    W)."""
    n_comp, s_, ny, nx = zvs.shape
    w_ = qx.shape[1]
    (i0, i1), (w0, w1) = tent_taps(qx, nx)

    def tap(idx, wt):
        cols = idx[None, :, None, :].expand(n_comp, s_, ny, w_)
        return wt[None, :, None, :] * torch.gather(zvs, 3, cols)

    return tap(i0, w0) + tap(i1, w1)


def render_slabs(grids: LevelGrids, fs, cfg: SlabConfig, cam_pos, cam_dir00,
                 cam_du, cam_dv, width: int, height: int, knots=None,
                 ky_hints=None, y_crop=None, lattice=None,
                 bf16: bool = False):
    """Sweep-render one frame: camera vectors in the grid frame (z = the
    sweep axis), separable, or ``lattice`` ((W,), (H,)).  Returns (P, 4)
    rgba in row-major pixel order."""
    if y_crop is not None:
        grids = crop_grids_y(grids, y_crop)
    dev = grids.device
    f32 = torch.float32
    h, w = height, width
    d00 = np.asarray(cam_dir00, np.float32)
    rx, ry, sec = ray_components(cam_dir00, cam_du, cam_dv, w, h, dev,
                                 lattice=lattice)

    z_lo = np.float32(grids.bounds_lo[0])
    dz = slab_spacing(grids, cfg.nslabs)
    oz, oy, ox = (_f32(v, "cpu") for v in np.asarray(cam_pos, np.float32))
    order = torch.arange(cfg.nslabs, dtype=f32)
    if cfg.flip:
        order = order.flip(0)
    z_planes = _f32(z_lo, "cpu") + (order + 0.5) * _f32(dz, "cpu")

    lut_np = np.asarray(fs.xf_lut, np.float32)
    dom_np = np.asarray(fs.xf_domain, np.float32)
    domains = torch.from_numpy(dom_np[:cfg.num_channels]).to(dev)
    if cfg.space_skipping:
        zranges = grids.zranges.cpu()
        zi = torch.clamp((z_planes - _f32(np.floor(z_lo), "cpu")).to(
            torch.int64), 0, zranges.shape[0] - 1)
        act = torch.zeros(cfg.nslabs, dtype=torch.bool)
        for c in range(cfg.num_channels):
            act = act | active_for_volume_sampling(
                torch.from_numpy(lut_np[c]), torch.from_numpy(dom_np[c]),
                _f32(fs.xf_opacity_scale, "cpu"), zranges[zi])
    else:
        act = torch.ones(cfg.nslabs, dtype=torch.bool)
    luts = [torch.from_numpy(l).to(dev)
            for l in scaled_luts(fs, cfg.num_channels)]
    tiles = (cfg.tile_rows, cfg.tile_cols)

    lvl_occ = _level_occupancy(grids, z_planes)
    s_chunk = effective_chunk(grids, cfg, h, w, ky_hints)
    n_chunks = -(-cfg.nslabs // s_chunk)
    pad = n_chunks * s_chunk - cfg.nslabs
    z_planes_p = torch.cat([z_planes, z_planes[-1:].expand(pad)])
    act_p = torch.cat([act, torch.zeros(pad, dtype=torch.bool)])
    lvl_occ_p = [torch.cat([o, torch.zeros(pad, dtype=torch.bool)])
                 for o in lvl_occ]

    def chunk_tables(ci):
        sl = slice(ci * s_chunk, (ci + 1) * s_chunk)
        z_s = z_planes_p[sl]
        scale = (z_s - oz) / _f32(d00[0], "cpu")
        return z_s, [o[sl] for o in lvl_occ_p], scale, act_p[sl]

    def chunk_products(z_s, occ_s, scale):
        """Per level the (C+1, S, ny, W) mids (z lerp, then the x tent
        resample) and the TF-cull value rows."""
        scale_d = scale.to(dev)
        z_d = z_s.to(dev)
        x_pos = ox.to(dev) + scale_d[:, None] * rx[None, :]
        mids = []
        for li, L in enumerate(grids.levels):
            cw = float(1 << L)
            m = grids.masks[li]
            org = grids.origins[li]
            nz = m.shape[0]
            qz = z_d / cw - _f32(org[0], dev) - 0.5
            gate = float(bool(occ_s[li].any()))
            k0z = torch.floor(qz).to(torch.int64)
            frz = qz - k0z.to(f32)
            wz0 = gate * torch.where((k0z >= 0) & (k0z < nz), 1.0 - frz, 0.0)
            wz1 = gate * torch.where((k0z + 1 >= 0) & (k0z + 1 < nz),
                                     frz, 0.0)
            i0z = torch.clamp(k0z, 0, nz - 1)
            i1z = torch.clamp(k0z + 1, 0, nz - 1)
            qx = x_pos / cw - _f32(org[2], dev) - 0.5
            comps = [grids.vals[li][c] for c in range(cfg.num_channels)]

            def zres(vol):
                return (wz0[:, None, None] * vol.index_select(0, i0z)
                        + wz1[:, None, None] * vol.index_select(0, i1z))

            zvs = rnd(torch.stack([zres(v) for v in comps + [m]]), bf16)
            mids.append(rnd(xresample_mids_reference(zvs, qx.contiguous()),
                            bf16))

        tf_cull = None
        if grids.vrange_zy and cfg.space_skipping:
            vr_rows = []
            for li, L in enumerate(grids.levels):
                cw = float(1 << L)
                nzl = grids.masks[li].shape[0]
                qz = z_d / cw - _f32(grids.origins[li][0], dev) - 0.5
                k0 = torch.floor(qz).to(torch.int64)
                vr = grids.vrange_zy[li]

                def zrow(k, vr=vr, nzl=nzl):
                    valid = ((k >= 0) & (k < nzl))[None, :, None]
                    r = vr[:, torch.clamp(k, 0, nzl - 1)]
                    return (torch.where(valid, r[..., 0], float("inf")),
                            torch.where(valid, r[..., 1], float("-inf")))

                r0 = zrow(k0)
                r1 = zrow(k0 + 1)
                vr_rows.append(torch.stack(
                    [torch.minimum(r0[0], r1[0]),
                     torch.maximum(r0[1], r1[1])], -1))
            tf_cull = (vr_rows, grids.y_bin)
        orgs_y = [float(o[1]) for o in grids.origins]
        cws_l = [float(1 << L) for L in grids.levels]
        return mids, orgs_y, cws_l, tf_cull

    tables = pack_luts(luts, domains, knots, dev)
    color = torch.zeros((3, h, w), dtype=f32, device=dev)
    alpha = torch.zeros((h, w), dtype=f32, device=dev)
    for ci in range(n_chunks):
        if not bool(alpha.min() < TERMINATION_THRESHOLD):
            break
        z_s, occ_s, scale, a_s = chunk_tables(ci)
        live = a_s & (scale > 1e-6)
        if not bool(live.any()):
            continue
        mids, orgs_y, cws_l, tf_cull = chunk_products(z_s, occ_s, scale)
        y_pos = (oy.to(dev) + scale.to(dev)[:, None] * ry[None, :]
                 ).contiguous()
        prep = prepare_chunk(mids, orgs_y, cws_l, y_pos, h, w, tiles=tiles,
                             adaptive_stride=cfg.adaptive_stride,
                             tf_cull=tf_cull)
        live_d = live.to(dev)
        act_f, act_all_f = combine_activity(
            prep, live_d, luts, domains, adaptive_stride=cfg.adaptive_stride)
        rgb, trans = sweep_chunk_reference(
            prep, sec, live_d, tables, dz, h, w, act_f=act_f,
            act_all_f=act_all_f, prev_trans=(1.0 - alpha).contiguous(),
            tiles=tiles, adaptive_stride=cfg.adaptive_stride, bf16=bf16)
        del mids, prep
        color = color + rgb
        alpha = 1.0 - trans

    if cfg.saturate_collapse:
        sat = alpha >= TERMINATION_THRESHOLD
        color = torch.where(sat[None], color * alpha[None], color)
        alpha = torch.where(sat, 1.0, alpha)
    rgba = torch.cat([color, alpha[None]], dim=0)
    return rgba.reshape(4, h * w).T


def render_slabs_camera(grids: LevelGrids, fs, cfg: SlabConfig, camera,
                        width: int, height: int, lattice=None,
                        bf16: bool = False):
    """Permute the camera, render transposed where pixel x runs along grid
    y, pick the sweep direction, crop the grids to the rows the rays
    reach, compress the transfer function to knots, and render.  Returns
    (P, 4) rgba in row-major pixel order."""
    axis = grids.axis
    if lattice is not None:
        swapped = False
    else:
        mapping = separable_mapping(camera, axis)
        if mapping is None:
            raise ValueError("camera is not separable along the sweep axis")
        (swapped,) = mapping
    pos, dir00, du, dv = permute_camera(camera, axis)
    cfg = dataclasses.replace(cfg, flip=bool(dir00[0] < 0))
    y_crop = (y_crop_for_camera(grids, cfg, pos, dir00, du, width)
              if swapped else
              y_crop_for_camera(grids, cfg, pos, dir00, dv, height,
                                lattice=lattice))
    knots = (compress_pwl(scaled_luts(fs, cfg.num_channels),
                          fit_tol=cfg.xf_fit_quantum / 255.0)
             if cfg.xf_compress and cfg.xf_knots == NUM_XF_VALUES else None)
    if not swapped:
        hints = ky_hints_for_camera(grids, cfg, pos, dir00, dv, height, width,
                                    lattice=lattice)
        return render_slabs(grids, fs, cfg, pos, dir00, du, dv, width,
                            height, knots=knots, ky_hints=hints,
                            y_crop=y_crop, lattice=lattice, bf16=bf16)
    hints = ky_hints_for_camera(grids, cfg, pos, dir00, du, width, height)
    rgba = render_slabs(grids, fs, cfg, pos, dir00, dv, du, height, width,
                        knots=knots, ky_hints=hints, y_crop=y_crop,
                        bf16=bf16)
    return rgba.reshape(width, height, 4).permute(1, 0, 2).reshape(-1, 4)

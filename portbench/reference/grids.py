"""Level grids from cells, and the reorientation preview's resampled grids
(frozen copies of ``slabs.level_grids_from_cells`` and
``slabs.reorient_grids`` of the port, plain torch and numpy)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .camera import Camera


def rnd(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back when ``bf16`` (the control's
    precision), else ``t``."""
    return t.to(torch.bfloat16).to(t.dtype) if bf16 else t


@dataclass
class LevelGrids:
    """Dense per-level voxel grids in (z, y, x) order after permuting the
    sweep axis to z: values (C, nz, ny, nx), masks (nz, ny, nx), the
    per-level lattice origins (host), the per-fine-z value ranges, the
    sweep bounds (host) and the per-level (C, nz, nyb, 2) y-bin value
    ranges."""

    vals: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]
    origins: Tuple[np.ndarray, ...]
    zranges: torch.Tensor
    bounds_lo: np.ndarray
    bounds_hi: np.ndarray
    vrange_zy: Tuple[torch.Tensor, ...] = ()
    levels: Tuple[int, ...] = ()
    num_channels: int = 1
    axis: int = 2
    y_bin: Tuple[int, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.masks[0].device


def _vrange_zy(vals, mask):
    vals, mask = torch.as_tensor(vals), torch.as_tensor(mask)
    c, nz, ny, nx = vals.shape
    bin_ = max(1, -(-ny // 32))
    nyb = -(-ny // bin_)
    pad = nyb * bin_ - ny
    occ = mask[None] > 0
    out = []
    for fill, red in ((float("inf"), torch.amin), (float("-inf"), torch.amax)):
        t = torch.where(occ, vals, fill)
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad), value=fill)
        out.append(red(t.reshape(c, nz, nyb, bin_, nx), dim=(3, 4)))
        del t
    return torch.stack(out, dim=-1).to(torch.float32), bin_


def _compute_zranges(levels, vals, masks, origins, lo_p, hi_p) -> np.ndarray:
    nz_fine = int(np.ceil(hi_p[0]) - np.floor(lo_p[0]))
    zr = np.stack(
        [np.full(nz_fine, np.inf, np.float32),
         np.full(nz_fine, -np.inf, np.float32)], axis=1,
    )
    z_lo = np.floor(lo_p[0])
    for li, (L, v, m) in enumerate(zip(levels, vals, masks)):
        cw = 1 << L
        orgz = float(origins[li][0])
        v, m = torch.as_tensor(v), torch.as_tensor(m)
        occ = m > 0
        has = occ.flatten(1).any(1).cpu().numpy()
        lo_k = torch.where(occ[None], v, float("inf")).amin(
            dim=(0, 2, 3)).cpu().numpy()
        hi_k = torch.where(occ[None], v, float("-inf")).amax(
            dim=(0, 2, 3)).cpu().numpy()
        for k in np.nonzero(has)[0]:
            f0 = int(max((orgz + k - 1) * cw - z_lo, 0))
            f1 = int(min((orgz + k + 2) * cw - z_lo, nz_fine))
            zr[f0:f1, 0] = np.minimum(zr[f0:f1, 0], lo_k[k])
            zr[f0:f1, 1] = np.maximum(zr[f0:f1, 1], hi_k[k])
    return zr


def perm_of(axis: int):
    """Old->new axis permutation: the sweep axis becomes index 0 of
    (z, y, x)."""
    other = [a for a in (2, 1, 0) if a != axis]
    return (axis, *other)


def _finish_grids(levels, vals, masks, origins, v_lo, v_hi, perm, c, axis,
                  device) -> LevelGrids:
    def t(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device).contiguous()

    vals = [t(v) for v in vals]
    masks = [t(m) for m in masks]
    pad = 0.5 * (1 << max(levels))
    lo_p = np.asarray([v_lo[p] - pad for p in perm], np.float32)
    hi_p = np.asarray([v_hi[p] + pad for p in perm], np.float32)
    zr = _compute_zranges(levels, vals, masks, origins, lo_p, hi_p)
    vr_zy = [_vrange_zy(v, m) for v, m in zip(vals, masks)]
    return LevelGrids(
        vals=tuple(vals), masks=tuple(masks), origins=tuple(origins),
        zranges=t(zr), bounds_lo=lo_p, bounds_hi=hi_p,
        vrange_zy=tuple(v for v, _ in vr_zy), levels=tuple(levels),
        num_channels=c, axis=axis, y_bin=tuple(b for _, b in vr_zy),
    )


def _level_frame(l_lo, l_hi, cw, perm):
    org = np.floor(l_lo / cw).astype(np.int64)
    dims = np.maximum(np.ceil(l_hi / cw).astype(np.int64) - org, 1)
    nz, ny, nx = (int(dims[perm[0]]), int(dims[perm[1]]),
                  int(dims[perm[2]]))
    return org, (nz, -(-ny // 8) * 8, nx)


def level_grids_from_cells(lower, level, scalars, axis: int, device,
                           bf16: bool = False) -> LevelGrids:
    """Dense per-level grids of the cells (lower (N, 3) x, y, z; level
    (N,); scalars (C, N)) for a sweep along ``axis``, scattered on
    ``device``."""
    dev = torch.device(device)
    scalars = np.asarray(scalars, np.float32)
    if scalars.ndim == 1:
        scalars = scalars[None]
    c = scalars.shape[0]
    perm = perm_of(axis)
    lower = torch.from_numpy(np.ascontiguousarray(lower)).to(dev).to(
        torch.int64)
    level = torch.from_numpy(np.ascontiguousarray(level)).to(dev).to(
        torch.int64)
    scal = torch.from_numpy(np.ascontiguousarray(scalars)).to(dev)

    levels = tuple(int(l) for l in torch.unique(level).tolist())
    vals, masks, origins, los, his = [], [], [], [], []
    for L in levels:
        cw = 1 << L
        sel = level == L
        low = lower[sel]
        l_lo = low.amin(0).cpu().numpy().astype(np.float32)
        l_hi = (low.amax(0).cpu().numpy().astype(np.float32)
                + np.float32(cw))
        los.append(l_lo)
        his.append(l_hi)
        org, (nz, ny, nx) = _level_frame(l_lo, l_hi, cw, perm)
        idx = torch.div(low, cw, rounding_mode="floor") - torch.from_numpy(
            org).to(dev)
        ii = tuple(idx[:, p] for p in perm)
        del low, idx
        v = torch.zeros((c, nz, ny, nx), dtype=torch.float32, device=dev)
        m = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
        v[(slice(None), *ii)] = rnd(scal[:, sel], bf16)
        m[ii] = 1.0
        vals.append(v)
        masks.append(m)
        origins.append(np.asarray([org[p] for p in perm], np.float32))
    del lower, level, scal
    return _finish_grids(levels, vals, masks, origins, np.min(los, 0),
                         np.max(his, 0), perm, c, axis, dev)


def reorient_grids(grids: LevelGrids, camera, bf16: bool = False):
    """The grids resampled (trilinear, scipy on the host) into the
    camera's frame, and the camera in that frame: separable, du along
    grid x, dv along grid y, view along z."""
    from scipy import ndimage

    du = np.asarray(camera.dir_du, np.float64)
    dv = np.asarray(camera.dir_dv, np.float64)
    u = du / np.linalg.norm(du)
    v = dv - (dv @ u) * u
    v = v / np.linalg.norm(v)
    w = np.cross(u, v)
    if np.asarray(camera.dir00, np.float64) @ w < 0:
        w = -w
        v = -v
    r = np.stack([u, v, w], axis=1)

    perm = perm_of(grids.axis)
    inv = [0, 0, 0]
    for gi, wa in enumerate(perm):
        inv[wa] = gi

    lo_g = np.asarray(grids.bounds_lo, np.float64)
    hi_g = np.asarray(grids.bounds_hi, np.float64)
    lo_w = np.asarray([lo_g[inv[a]] for a in range(3)])
    hi_w = np.asarray([hi_g[inv[a]] for a in range(3)])
    corners = np.asarray(
        [[lo_w[0] if i & 1 == 0 else hi_w[0],
          lo_w[1] if i & 2 == 0 else hi_w[1],
          lo_w[2] if i & 4 == 0 else hi_w[2]] for i in range(8)]
    )
    cam_corners = corners @ r
    center = 0.5 * (cam_corners.min(axis=0) + cam_corners.max(axis=0))
    diag = float(np.linalg.norm(hi_w - lo_w))

    new_vals, new_masks, new_origins = [], [], []
    for li, L in enumerate(grids.levels):
        cw = float(1 << L)
        nfix = int(np.ceil(diag / cw)) + 2
        org_new = np.floor(center / cw - nfix / 2).astype(np.int64)
        org_old = np.asarray(grids.origins[li], np.float64)
        m = np.zeros((3, 3))
        off = np.zeros(3)
        for a in range(3):
            gi = inv[a]
            for b in range(3):
                m[gi, 2 - b] = r[a, b]
            off[gi] = (r[a] @ ((org_new + 0.5) * cw) / cw
                       - org_old[gi] - 0.5)

        def resample(arr):
            return ndimage.affine_transform(
                arr, m, offset=off, output_shape=(nfix, nfix, nfix),
                order=1, mode="constant", cval=0.0)

        new_masks.append(resample(grids.masks[li].cpu().numpy()).astype(
            np.float32))
        vals = grids.vals[li].cpu().numpy()
        new_vals.append(np.stack([resample(vals[c])
                                  for c in range(vals.shape[0])]).astype(
            np.float32))
        new_origins.append(
            np.asarray([org_new[2], org_new[1], org_new[0]], np.float32))

    cw0 = float(1 << grids.levels[0])
    n0 = int(np.ceil(diag / cw0)) + 2
    lo_xyz = (np.floor(center / cw0 - n0 / 2)) * cw0
    hi_xyz = lo_xyz + n0 * cw0
    lo_p = np.asarray([lo_xyz[2], lo_xyz[1], lo_xyz[0]], np.float32)
    hi_p = np.asarray([hi_xyz[2], hi_xyz[1], hi_xyz[0]], np.float32)
    zr = _compute_zranges(list(grids.levels), new_vals, new_masks,
                          new_origins, lo_p, hi_p)
    vr_zy = []
    for v_, mk in zip(new_vals, new_masks):
        ratio = np.where(mk[None] > 0, v_ / np.maximum(mk[None], 1e-20),
                         0.0).astype(np.float32)
        vr_zy.append(_vrange_zy(ratio, mk))

    dev = grids.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    grids_rot = LevelGrids(
        vals=tuple(rnd(t(v_), bf16) for v_ in new_vals),
        masks=tuple(t(mk) for mk in new_masks),
        origins=tuple(new_origins), zranges=t(zr), bounds_lo=lo_p,
        bounds_hi=hi_p, vrange_zy=tuple(tb.to(dev) for tb, _ in vr_zy),
        levels=grids.levels, num_channels=grids.num_channels, axis=2,
        y_bin=tuple(b for _, b in vr_zy),
    )
    cam_rot = Camera(
        pos=(np.asarray(camera.pos, np.float64) @ r).astype(np.float32),
        dir00=(np.asarray(camera.dir00, np.float64) @ r).astype(np.float32),
        dir_du=(du @ r).astype(np.float32),
        dir_dv=(dv @ r).astype(np.float32),
    )
    return grids_rot, cam_rot


def crop_grids_y(grids: LevelGrids, crops) -> LevelGrids:
    """Slice each level's rows to a ``y_crop_for_camera`` crop."""
    vals, masks, origins, vr = [], [], [], []
    for li, (c0, rows) in enumerate(crops):
        masks.append(grids.masks[li][:, c0:c0 + rows, :])
        vals.append(grids.vals[li][:, :, c0:c0 + rows, :])
        origins.append(grids.origins[li]
                       + np.asarray([0.0, c0, 0.0], np.float32))
        if grids.vrange_zy:
            bin_ = int(grids.y_bin[li])
            b0 = c0 // bin_
            b1 = -(-(c0 + rows) // bin_)
            vr.append(grids.vrange_zy[li][:, :, b0:b1, :])
    return dataclasses.replace(
        grids, vals=tuple(vals), masks=tuple(masks), origins=tuple(origins),
        vrange_zy=tuple(vr) if grids.vrange_zy else (),
    )

"""Slab-sweep DVR for axis-aligned cameras and shear-warp lattice
cameras (the port of ``owlexabrick_tpu/render/slabs.py``: the megakernel
lane, the einsum lane and the iso sweep), and the ``reorient_grids``
preview for frusta no axis can factorize.

The AMR field is held as dense per-level voxel grids (value + cell mask);
summing tent-weighted contributions over levels is exactly the exa-brick
basis reconstruction (exabrick.cu:620-816).  The volume is swept in
axis-aligned slabs along the camera's principal axis; for a camera whose
image plane is perpendicular to that axis, resampling a level onto the
pixel grid is separable.  Per chunk of slabs the camera products are a
2-tap z lerp (plain torch) and a 2-tap x lerp (K6 on the card,
``render/mids.py``) of every level into per-level "mids" (S, ny, W); the
sweep kernel (``sweep.run_chunk``, K1 on the card) does the y lerp,
classification and front-to-back compositing, up to a per-pixel surface
stop ``t_stop``.

The einsum lane serves what the megakernel cannot: the clip box's
per-pixel interval start ``t_start`` and DVR gradient shading.  With one
channel and no shading, per chunk it builds the live slabs' mids as the
megakernel lane does (z lerp in torch, x lerp by K6) and K3 does the y
lerp, the clip masks, the classification and the composite per pixel
(``render/classify.py``).  Otherwise it rebuilds the fields sw, swv (and
their gradients) at every pixel of every slab, z then x then y, with
2-tap lerps (plain torch, as the JAX package left them to XLA), then
classifies them with K4 per channel, followed by the headlight shading,
the channel merge and a cumprod composite in torch.

The iso sweep (``render_slabs_iso``) rebuilds the fields and their
gradients per batch of active slabs in the JAX package's z, y, x order
and scans for iso crossings slab by slab (plain torch); its colormap
recolor is K5.  Its hit depth is the volume's ``t_stop``.

Host-side pieces (the per-brick grid scatter, knot compression, camera
separability, y crop, window hints, chunk depth) are numpy, as in the
JAX package, so both packages derive the same integers and knots; the
cell scatter (``level_grids_from_cells``) and the grids' TF-cull tables
run on the grids' device, as exact gathers, scatters and min/max.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.constants import NUM_XF_VALUES, TERMINATION_THRESHOLD
from ..utils import profiling
from .classify import (
    classify_field,
    composite_mids,
    texel_coord,
    xf_classify,
)
from .mids import tent_taps, xresample_mids_levels
from .sweep import (
    combine_activity,
    pack_luts,
    prepare_chunk,
    run_chunk,
    tile_shape,
)
from .xf import active_for_volume_sampling


@dataclass
class LevelGrids:
    """Dense per-level voxel grids in (z, y, x) order after permuting the
    chosen principal axis to z.

    ``vals``, ``masks``, ``zranges`` and ``vrange_zy`` are torch tensors
    on the render device (``to(device)`` moves them); the per-level
    lattice origins and the sweep bounds are a few host floats and stay
    numpy, so slab positions are derived without a device round trip."""

    vals: Tuple[torch.Tensor, ...]  # per level (C, nz, ny, nx) float32
    masks: Tuple[torch.Tensor, ...]  # per level (nz, ny, nx) float32 (1=cell)
    origins: Tuple[np.ndarray, ...]  # per level (3,) float32 origin (z,y,x)
    zranges: torch.Tensor  # (nz_fine, 2) per-fine-z value min/max
    bounds_lo: np.ndarray  # (3,) float32 (z, y, x) voxel bounds
    bounds_hi: np.ndarray  # (3,)
    # per level (C, nz, nyb, 2): value min/max over x and y-bins of
    # ``y_bin[level]`` lattice rows (empty bins [inf, -inf])
    vrange_zy: Tuple[torch.Tensor, ...] = ()
    levels: Tuple[int, ...] = ()
    num_channels: int = 1
    axis: int = 2  # which original axis is the sweep ('z') axis
    y_bin: Tuple[int, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.masks[0].device

    def to(self, device) -> "LevelGrids":
        return dataclasses.replace(
            self,
            vals=tuple(v.to(device) for v in self.vals),
            masks=tuple(m.to(device) for m in self.masks),
            zranges=self.zranges.to(device),
            vrange_zy=tuple(v.to(device) for v in self.vrange_zy),
        )


def _vrange_zy(vals, mask):
    """(C, nz, nyb, 2) masked value min/max over x + y-bins, and the bin
    (rows per bin).  ``vals`` (C, nz, ny, nx) and ``mask`` (nz, ny, nx):
    torch tensors (reduced on their device) or numpy arrays."""
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
    """Per-fine-z value min/max over all levels (for slab TF culling), a
    host (nz_fine, 2) array.  ``vals`` / ``masks``: per level torch
    tensors (reduced per z slice on their device) or numpy arrays."""
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
        # each z slice's min / max over its cells' values, every channel
        lo_k = torch.where(occ[None], v, float("inf")).amin(
            dim=(0, 2, 3)).cpu().numpy()
        hi_k = torch.where(occ[None], v, float("-inf")).amax(
            dim=(0, 2, 3)).cpu().numpy()
        for k in np.nonzero(has)[0]:
            # cell k at level L covers fine z in [(orgz+k)*cw,
            # (orgz+k+1)*cw); basis support extends one cell each way
            f0 = int(max((orgz + k - 1) * cw - z_lo, 0))
            f1 = int(min((orgz + k + 2) * cw - z_lo, nz_fine))
            zr[f0:f1, 0] = np.minimum(zr[f0:f1, 0], lo_k[k])
            zr[f0:f1, 1] = np.maximum(zr[f0:f1, 1], hi_k[k])
    return zr


def _perm(axis: int):
    """Old->new axis permutation: the sweep axis becomes index 0 of
    (z, y, x)."""
    other = [a for a in (2, 1, 0) if a != axis]
    return (axis, *other)


def render_device(device) -> torch.device:
    """``device`` as a torch.device.  Asking for a CUDA device where no
    card is available raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} asked for, but no CUDA "
                           "card is available (pass device='cpu')")
    return device


def _finish_grids(levels, vals, masks, origins, v_lo, v_hi, perm, c,
                  axis, device) -> LevelGrids:
    """LevelGrids on ``device`` from per-level values and masks (numpy
    arrays or torch tensors): the sweep bounds and the TF-cull tables,
    reduced on ``device``."""
    device = render_device(device)

    def t(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device).contiguous()

    vals = [t(v) for v in vals]
    masks = [t(m) for m in masks]
    # sweep bounds = union of basis-function domains (brick bounds padded
    # by half the coarsest cell width, ExaBricks.h:55-60)
    pad = 0.5 * (1 << max(levels))
    lo_p = np.asarray([v_lo[p] - pad for p in perm], np.float32)
    hi_p = np.asarray([v_hi[p] + pad for p in perm], np.float32)
    zr = _compute_zranges(levels, vals, masks, origins, lo_p, hi_p)
    vr_zy = [_vrange_zy(v, m) for v, m in zip(vals, masks)]
    return LevelGrids(
        vals=tuple(vals),
        masks=tuple(masks),
        origins=tuple(origins),
        zranges=t(zr),
        bounds_lo=lo_p,
        bounds_hi=hi_p,
        vrange_zy=tuple(v for v, _ in vr_zy),
        levels=tuple(levels),
        num_channels=c,
        axis=axis,
        y_bin=tuple(b for _, b in vr_zy),
    )


def _level_frame(l_lo, l_hi, cw, perm):
    """Lattice origin (x, y, z) and permuted (nz, ny8, nx) dims of one
    level cropped to its own bounding box (exact: tent weights vanish
    outside the lattice).  ny rounds up to 8 with zero-mask rows, as the
    JAX package's grids do, so both packages hold the same arrays."""
    org = np.floor(l_lo / cw).astype(np.int64)
    dims = np.maximum(np.ceil(l_hi / cw).astype(np.int64) - org, 1)
    nz, ny, nx = (int(dims[perm[0]]), int(dims[perm[1]]),
                  int(dims[perm[2]]))
    return org, (nz, -(-ny // 8) * 8, nx)


def build_level_grids(bricks, scalars, axis: int = 2,
                      device="cuda") -> LevelGrids:
    """Scatter bricks into dense per-level grids (host side, then moved
    to ``device``).  ``bricks``: any object with the JAX package's
    ``Bricks`` fields (lower, size, level, begin as numpy arrays); cells
    are flattened x-fastest per brick (programs/Brick.h:61-64)."""
    scalars = np.asarray(scalars, np.float32)
    if scalars.ndim == 1:
        scalars = scalars[None]
    c = scalars.shape[0]
    perm = _perm(axis)
    b_lower = np.asarray(bricks.lower)
    b_size = np.asarray(bricks.size)
    b_level = np.asarray(bricks.level)
    b_begin = np.asarray(bricks.begin)
    cwb = (1 << b_level.astype(np.int64)).astype(np.float32)
    lo3 = b_lower.astype(np.float32)
    hi3 = lo3 + b_size.astype(np.float32) * cwb[:, None]

    levels = tuple(sorted(int(l) for l in np.unique(b_level)))
    vals, masks, origins = [], [], []
    for L in levels:
        cw = 1 << L
        sel = np.nonzero(b_level == L)[0]
        org, (nz, ny, nx) = _level_frame(lo3[sel].min(0), hi3[sel].max(0),
                                         cw, perm)
        v = np.zeros((c, nz, ny, nx), np.float32)
        m = np.zeros((nz, ny, nx), np.float32)
        for b in sel:
            sx, sy, sz = (int(s) for s in b_size[b])
            i0 = (b_lower[b] // cw - org).astype(np.int64)  # (x, y, z)
            beg = int(b_begin[b])
            block = scalars[:, beg:beg + sx * sy * sz].reshape(c, sz, sy, sx)
            blk = np.transpose(block, (0, 3, 2, 1))  # (c, x, y, z)
            size = (sx, sy, sz)
            sl = tuple(slice(int(i0[p]), int(i0[p]) + size[p]) for p in perm)
            v[(slice(None), *sl)] = np.transpose(
                blk, (0, 1 + perm[0], 1 + perm[1], 1 + perm[2]))
            m[sl] = 1.0
        vals.append(v)
        masks.append(m)
        origins.append(np.asarray([org[p] for p in perm], np.float32))
    return _finish_grids(levels, vals, masks, origins, lo3.min(0),
                         hi3.max(0), perm, c, axis, device)


def level_grids_from_cells(lower, level, scalars, axis: int = 2,
                           device="cuda") -> LevelGrids:
    """Level grids straight from cells (the cell-scatter twin of
    ``build_level_grids``): bricks only partition the cells and the basis
    lives on the cells, so no brick builder is needed.  The scatter and
    the TF-cull tables run on ``device`` (the card unless the caller asks
    for the CPU).  lower: (N, 3) int (x, y, z); level: (N,); scalars:
    (C, N) or (N,)."""
    dev = render_device(device)
    scalars = np.asarray(scalars, np.float32)
    if scalars.ndim == 1:
        scalars = scalars[None]
    c = scalars.shape[0]
    perm = _perm(axis)
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
        # the level's box in float32, as lower.astype(float32) (+ cw)
        # rounds it (rounding is monotone, so min / max commute with it)
        l_lo = low.amin(0).cpu().numpy().astype(np.float32)
        l_hi = (low.amax(0).cpu().numpy().astype(np.float32)
                + np.float32(cw))
        los.append(l_lo)
        his.append(l_hi)
        org, (nz, ny, nx) = _level_frame(l_lo, l_hi, cw, perm)
        idx = torch.div(low, cw, rounding_mode="floor") - torch.from_numpy(
            org).to(dev)  # (n, 3) x, y, z
        ii = tuple(idx[:, p] for p in perm)
        del low, idx
        v = torch.zeros((c, nz, ny, nx), dtype=torch.float32, device=dev)
        m = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
        v[(slice(None), *ii)] = scal[:, sel]
        m[ii] = 1.0
        vals.append(v)
        masks.append(m)
        origins.append(np.asarray([org[p] for p in perm], np.float32))
    del lower, level, scal
    return _finish_grids(levels, vals, masks, origins, np.min(los, 0),
                         np.max(his, 0), perm, c, axis, dev)


# ----------------------------------------------------------------------------
# camera separability
# ----------------------------------------------------------------------------

def principal_axis(direction) -> int:
    return int(np.argmax(np.abs(np.asarray(direction))))


def permute_camera(camera, axis: int):
    """Permute camera vectors from world (x,y,z) to grid (z,y,x) frame."""
    perm = _perm(axis)

    def p(v):
        v = np.asarray(v)
        return np.asarray([v[perm[0]], v[perm[1]], v[perm[2]]], np.float32)

    return p(camera.pos), p(camera.dir00), p(camera.dir_du), p(camera.dir_dv)


def separable_mapping(camera, axis: int, atol: float = 1e-5):
    """None if the camera is not separable for a sweep along ``axis``,
    else (swapped,): swapped=True means pixel-x steps run along grid-y
    and pixel-y steps along grid-x (rendered transposed)."""
    _, _, du_p, dv_p = permute_camera(camera, axis)
    if abs(du_p[0]) >= atol or abs(dv_p[0]) >= atol:
        return None  # image plane not perpendicular to the axis
    if abs(du_p[1]) < atol and abs(dv_p[2]) < atol:
        return (False,)
    if abs(du_p[2]) < atol and abs(dv_p[1]) < atol:
        return (True,)
    return None


def check_separable(camera, axis: int, atol: float = 1e-5) -> bool:
    return separable_mapping(camera, axis, atol) is not None


def camera_to_voxel(camera, voxel_from_world):
    """Transform a world-space camera into voxel space (the remap_from/
    remap_to affine, exa/Config.cpp:23-44; diagonal, so separability is
    preserved)."""
    from .camera import Camera

    m = np.asarray(voxel_from_world, np.float64)
    a = m[:, :3]
    b = m[:, 3]
    return Camera(
        pos=(a @ np.asarray(camera.pos, np.float64) + b).astype(np.float32),
        dir00=(a @ np.asarray(camera.dir00, np.float64)).astype(np.float32),
        dir_du=(a @ np.asarray(camera.dir_du, np.float64)).astype(np.float32),
        dir_dv=(a @ np.asarray(camera.dir_dv, np.float64)).astype(np.float32),
    )


def reorient_grids(grids: LevelGrids, camera):
    """Resample the level grids into a camera-aligned frame so the aligned
    sweep applies to a camera no shear-warp axis can factorize (the
    Renderer's bounded-time preview for wide-fov near-diagonal views).

    The rotated lattice holds trilinear resamples of the (value*mask) and
    mask grids (host numpy + ``scipy.ndimage.affine_transform``, as in the
    JAX package).  Returns (rotated LevelGrids on the grids' device, the
    camera in the rotated frame: separable, du along grid x, dv along
    grid y, view along z)."""
    from scipy import ndimage

    from .camera import Camera

    du = np.asarray(camera.dir_du, np.float64)
    dv = np.asarray(camera.dir_dv, np.float64)
    # orthonormal camera frame (du, dv are orthogonal for look_at cameras)
    u = du / np.linalg.norm(du)
    v = dv - (dv @ u) * u
    v = v / np.linalg.norm(v)
    w = np.cross(u, v)
    # sweep axis points along the mean view direction
    if np.asarray(camera.dir00, np.float64) @ w < 0:
        w = -w
        v = -v  # keep the frame right-handed with w flipped
    r = np.stack([u, v, w], axis=1)  # world = r @ cam

    # un-permute current grids to world (x, y, z) axis order
    perm = _perm(grids.axis)  # grid (z,y,x) = world axes perm
    inv = [0, 0, 0]
    for gi, wa in enumerate(perm):
        inv[wa] = gi  # world axis wa lives at grid index inv[wa]

    # world-space corners of the current bounds -> camera-frame AABB
    lo_g = np.asarray(grids.bounds_lo, np.float64)
    hi_g = np.asarray(grids.bounds_hi, np.float64)
    lo_w = np.asarray([lo_g[inv[a]] for a in range(3)])
    hi_w = np.asarray([hi_g[inv[a]] for a in range(3)])
    corners = np.asarray(
        [[lo_w[0] if i & 1 == 0 else hi_w[0],
          lo_w[1] if i & 2 == 0 else hi_w[1],
          lo_w[2] if i & 4 == 0 else hi_w[2]] for i in range(8)]
    )
    cam_corners = corners @ r  # r^T applied to rows
    center = 0.5 * (cam_corners.min(axis=0) + cam_corners.max(axis=0))

    # fixed output dims (the rotation-max cube): every orientation gets
    # the same shapes
    diag = float(np.linalg.norm(hi_w - lo_w))

    new_vals, new_masks, new_origins = [], [], []
    for li, L in enumerate(grids.levels):
        cw = float(1 << L)
        nfix = int(np.ceil(diag / cw)) + 2
        org_new = np.floor(center / cw - nfix / 2).astype(np.int64)
        org_old = np.asarray(grids.origins[li], np.float64)  # grid order
        # in_index = m @ out_index + off, both in (z, y, x) order; out grid
        # order (z, y, x) = camera axes (2, 1, 0)
        m = np.zeros((3, 3))
        off = np.zeros(3)
        for a in range(3):  # world axis
            gi = inv[a]  # slot in the old grid's (z, y, x)
            for b in range(3):  # camera axis
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

    # fixed sweep bounds (the rotation-max cube of the finest lattice)
    cw0 = float(1 << grids.levels[0])
    n0 = int(np.ceil(diag / cw0)) + 2
    lo_xyz = (np.floor(center / cw0 - n0 / 2)) * cw0
    hi_xyz = lo_xyz + n0 * cw0
    lo_p = np.asarray([lo_xyz[2], lo_xyz[1], lo_xyz[0]], np.float32)
    hi_p = np.asarray([hi_xyz[2], hi_xyz[1], hi_xyz[0]], np.float32)
    zr = _compute_zranges(list(grids.levels), new_vals, new_masks,
                          new_origins, lo_p, hi_p)

    # TF-cull value tables: rotated cells hold weight-scaled values, so
    # the bounded quantity is the ratio val/mask (a convex combination of
    # original cell values)
    vr_zy = []
    for v_, mk in zip(new_vals, new_masks):
        ratio = np.where(mk[None] > 0, v_ / np.maximum(mk[None], 1e-20),
                         0.0).astype(np.float32)
        vr_zy.append(_vrange_zy(ratio, mk))

    dev = grids.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    grids_rot = LevelGrids(
        vals=tuple(t(v_) for v_ in new_vals),
        masks=tuple(t(mk) for mk in new_masks),
        origins=tuple(new_origins),
        zranges=t(zr),
        bounds_lo=lo_p,
        bounds_hi=hi_p,
        vrange_zy=tuple(tb.to(dev) for tb, _ in vr_zy),
        levels=grids.levels,
        num_channels=grids.num_channels,
        axis=2,  # the camera frame's z is the sweep axis
        y_bin=tuple(b for _, b in vr_zy),
    )
    cam_rot = Camera(
        pos=(np.asarray(camera.pos, np.float64) @ r).astype(np.float32),
        dir00=(np.asarray(camera.dir00, np.float64) @ r).astype(np.float32),
        dir_du=(du @ r).astype(np.float32),
        dir_dv=(dv @ r).astype(np.float32),
    )
    return grids_rot, cam_rot


# ----------------------------------------------------------------------------
# transfer-function knot compression (host numpy)
# ----------------------------------------------------------------------------

def _pwl_breakpoints(lut: np.ndarray, err_tol: float):
    """Sparsest breakpoint set whose reconstruction of ``lut`` stays
    within err_tol at every texel."""
    n = lut.shape[0]
    d = np.diff(lut, axis=0)  # (N-1, 4)
    dd = np.abs(np.diff(d, axis=0)).max(axis=1)  # (N-2,)
    scale = max(float(np.abs(d).max()), 1e-20)
    u = np.arange(n, dtype=np.float64)
    for tol in (3e-2, 1e-2, 3e-3, 1e-3, 1e-4, 1e-5, 0.0):
        bp = np.concatenate([[0], 1 + np.nonzero(dd > tol * scale)[0]])
        # slope after breakpoint k is the exact lut slope there
        sd = np.empty((len(bp), 4), np.float64)
        prev = np.zeros(4)
        for j, k in enumerate(bp):
            sd[j] = d[k] - prev
            prev = d[k]
        rec = lut[0][None] + (
            np.maximum(u[:, None] - bp[None], 0.0)[:, :, None] * sd[None]
        ).sum(1)
        if np.abs(rec - lut).max() <= err_tol:
            return bp.astype(np.float32), sd.astype(np.float32)
    return None  # unreachable: tol 0 keeps every slope change


@dataclass
class XFKnots:
    """Compressed classification knots: ``f(u) = base + sum_j sd_j *
    relu(u - pos_j)`` per channel; ``cum`` holds the prefix sums
    (cum[:, k, :4] = sum_{j<k} sd, cum[:, k, 4:] = sum_{j<k} sd*pos) for
    the two-sided knot window; ``tau[c]`` marks channels whose 4th
    component is optical depth -log(1-alpha)."""

    pos: np.ndarray  # (C, M)
    sd: np.ndarray  # (C, M, 4)
    base: np.ndarray  # (C, 4)
    cum: np.ndarray  # (C, M+1, 8)
    tau: Tuple[bool, ...] = ()


def _pwl_fit(lut: np.ndarray, err_tol, max_knots: int = 64):
    """Greedy longest-segment minimax PWL fit of an (N, comp) LUT within
    a per-texel tolerance tube (the funnel construction); returns
    (positions, slope-deltas) in relu-basis form, or None."""
    n = lut.shape[0]
    comp = lut.shape[1]
    lut64 = lut.astype(np.float64)
    tol = np.broadcast_to(np.asarray(err_tol, np.float64), (n, comp))
    ks = [0]
    vals = [lut64[0].copy()]
    while ks[-1] < n - 1:
        p0 = ks[-1]
        v0 = vals[-1]
        best_end = p0 + 1
        best_v1 = lut64[best_end].copy()
        end = p0 + 1
        while end < n:
            lo = np.full(comp, -np.inf)
            hi = np.full(comp, np.inf)
            span = end - p0
            feasible = True
            for u in range(p0 + 1, end + 1):
                t = (u - p0) / span
                lo_u = (lut64[u] - tol[u] - v0 * (1 - t)) / t
                hi_u = (lut64[u] + tol[u] - v0 * (1 - t)) / t
                lo = np.maximum(lo, lo_u)
                hi = np.minimum(hi, hi_u)
                if (lo > hi).any():
                    feasible = False
                    break
            if not feasible:
                break
            best_end = end
            best_v1 = np.clip((lo + hi) * 0.5, lo, hi)
            end += 1
        ks.append(best_end)
        vals.append(best_v1)
        if len(ks) > max_knots:
            return None
    ks = np.asarray(ks, np.float64)
    vals = np.asarray(vals)
    slopes = np.diff(vals, axis=0) / np.diff(ks)[:, None]
    sd = np.empty((len(ks) - 1, comp), np.float64)
    sd[0] = slopes[0]
    sd[1:] = np.diff(slopes, axis=0)
    return ks[:-1].astype(np.float32), sd.astype(np.float32)


def compress_pwl(luts_np, err_tol: float = 2e-4,
                 fit_tol: float = 1.0 / 255.0, allow_tau: bool = True):
    """Compress per-channel (N, 4) LUTs to their PWL breakpoints (exact
    breakpoints where few exist, else an optical-depth minimax refit
    within one display quantum).  Returns an :class:`XFKnots`
    (positions padded to a multiple of 8 knots at position N), or None
    when the dense loop is competitive.  Same algorithm as the JAX
    package's ``compress_pwl``, so the knots are equal."""
    ps, sds, bases, taus = [], [], [], []
    n = luts_np[0].shape[0]
    for lut in luts_np:
        lut = np.asarray(lut, np.float32)
        r = _pwl_breakpoints(lut, err_tol)
        is_tau = False
        if r is not None and len(r[0]) > 48:
            r = None
        base_c = lut[0].astype(np.float32)
        if r is None and allow_tau:
            # optical-depth refit: a per-texel tau tolerance of
            # fit_tol * max(e*tau, 1/2) keeps alpha within ~fit_tol
            a = np.clip(lut[:, 3].astype(np.float64), 0.0, 1.0 - 1e-12)
            tau_col = -np.log1p(-a)
            tl = np.stack(
                [lut[:, 0], lut[:, 1], lut[:, 2], tau_col], 1
            ).astype(np.float32)
            tol = np.full((n, 4), fit_tol)
            tol[:, 3] = fit_tol * np.maximum(np.e * tau_col, 0.5)
            r = _pwl_fit(tl, tol)
            if r is not None:
                is_tau = True
                base_c = tl[0]
        if r is None:
            r = _pwl_fit(lut, fit_tol)
        if r is None:
            return None
        ps.append(r[0])
        sds.append(r[1])
        bases.append(base_c)
        taus.append(is_tau)
    m = max(len(p) for p in ps)
    m_pad = -(-m // 8) * 8
    if m_pad > 64:
        return None
    c = len(luts_np)
    pos = np.full((c, m_pad), float(n), np.float32)
    sd_a = np.zeros((c, m_pad, 4), np.float32)
    for ci in range(c):
        pos[ci, :len(ps[ci])] = ps[ci]
        sd_a[ci, :len(ps[ci])] = sds[ci]
    cum = np.zeros((c, m_pad + 1, 8), np.float32)
    cum[:, 1:, :4] = np.cumsum(sd_a, axis=1)
    cum[:, 1:, 4:] = np.cumsum(sd_a * pos[..., None], axis=1)
    return XFKnots(pos=pos, sd=sd_a, base=np.stack(bases), cum=cum,
                   tau=tuple(taus))


@dataclass(frozen=True)
class SlabConfig:
    """Slab-sweep settings: the fields of the JAX package's ``SlabConfig``
    that change the image or the lane (same names and defaults), plus
    ``xf_compress`` and ``plain_sweep``.  By default the sweep culls
    slabs and tiles by the transfer function (``space_skipping``) and the
    megakernel lane classifies the 128-texel LUT through its PWL knots;
    ``xf_knots`` != 128 resamples the LUT to that many texels and
    classifies it dense."""

    num_channels: int = 1
    nslabs: int = 128
    # collapse saturated pixels to premultiplied-opaque at the end
    # (exabrick.cu:1694-97); the banded sweep defers it to its combiner
    saturate_collapse: bool = True
    # the megakernel lane classifies through the LUT's PWL knots (within
    # xf_fit_quantum display quanta, compress_pwl); False classifies the
    # dense LUT, as the JAX package does for a frame state held on its
    # device (its offline CLI's --fast frames)
    xf_compress: bool = True
    # slabs per chunk (capped by effective_chunk)
    chunk: int = 12
    # sweep back to front along z (set from the view direction)
    flip: bool = False
    # cull slabs whose z value range the transfer function leaves
    # transparent, and tiles by their rows' value ranges (TF-aware
    # lateral cull); False integrates every slab in front of the eye
    space_skipping: bool = True
    # LUT texels per channel: any other value than 128 resamples each
    # channel's opacity-scaled LUT linearly to this many texels (the
    # JAX package's speed mode) and turns the knot compression off
    xf_knots: int = NUM_XF_VALUES
    # PWL-fit tolerance of the knot compression in display quanta
    # (fit_tol = xf_fit_quantum / 255)
    xf_fit_quantum: float = 1.0
    # False sends every frame to the einsum lane (one channel without
    # shading: K6 then K3 from the mids), as gradient shading does
    megakernel: bool = True
    # sweep tile shape overrides (0 = auto, sweep.tile_shape): the
    # per-tile activity, stride and saturation tables follow the tile
    tile_rows: int = 0
    tile_cols: int = 0
    # the JAX package's VMEM budget for the chunk-depth rule
    # (effective_chunk); kept because the chunk depth is quadrature
    chunk_budget_mb: int = 7
    # camera-product cache gate in MB; None = half the card's memory
    # (4096 on the CPU)
    camera_cache_max_mb: Optional[float] = None
    # adaptive z-stride (the reference's per-region dt = global_dt *
    # finestLevelCellWidth, exabrick.cu:1129)
    adaptive_stride: bool = False
    # DVR headlight gradient shading (integrateVolume,
    # exabrick.cu:1004-1010); takes the einsum lane
    gradient_shading_dvr: bool = False
    # iso shading (render_slabs_iso): analytic basis gradients,
    # .3 + .7|N.L| (gradientShadingISO, exabrick.cu:1060-1073); False =
    # the unshaded TF color, like the reference
    gradient_shading_iso: bool = True
    # secondary channel that recolors iso hits through the channel-0 LUT
    # (LaunchParams colormapChannel, exabrick.cu:1079-1085); 0 = off
    colormap_channel: int = 0
    # run the plain-torch versions of the kernels even for CUDA tensors:
    # the sweep (K1), the einsum lane's classification (K3, K4), the
    # camera products' x stage (K6), the iso colormap lookup (K5) and, in
    # render_slabs_shearwarp, the two-pass warp (K2a, K2b).  The explicit
    # comparison lane for the kernels, never chosen implicitly
    plain_sweep: bool = False


def _ray_rows(d00, cam_dv, height: int, lattice):
    """Per-row lateral ray component ry (float64): from the lattice's row
    array when given, else the affine camera's."""
    if lattice is not None:
        return np.asarray(lattice[1], np.float64)
    dv1 = float(np.asarray(cam_dv, np.float64)[1])
    return d00[1] + (np.arange(height) + 0.5) * dv1


def y_crop_for_camera(grids: LevelGrids, cfg: SlabConfig, cam_pos,
                      cam_dir00, cam_dv, height: int, lattice=None):
    """Global per-level y crop (c0, rows) covering every lattice row any
    of this render's rays can reach over the whole sweep — exact (tent
    weights outside the reach are zero).  c0 aligns to lcm(8, y_bin) so
    the TF-cull bins slice exactly; rows is 16-bucketed.  None when no
    level saves >= 25%.  ``lattice``: the ((W,), (H,)) ray arrays of a
    shear-warp lattice camera (ry from ``lattice[1]``)."""
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


def crop_grids_y(grids: LevelGrids, crops) -> LevelGrids:
    """Apply a y_crop_for_camera crop: slice each level's rows (views),
    shift its origin, and slice the TF-cull bins (c0 is bin-aligned)."""
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


def ky_hints_for_camera(grids: LevelGrids, cfg: SlabConfig, cam_pos,
                        cam_dir00, cam_dv, height: int, width: int,
                        lattice=None):
    """Per-level y-window row counts: the worst row-tile ray span at the
    farthest slab plus the chunk's depth-scale variation, with margin,
    in 16-row buckets.  The port reads no windows; the hints feed the
    chunk-depth rule (``effective_chunk``) exactly as in the JAX
    package.  ``lattice`` as in ``y_crop_for_camera``."""
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


def megakernel_lane(cfg: SlabConfig, t_start=None) -> bool:
    """The lane ``render_slabs`` takes (the JAX package's ``_mode_flags``):
    the megakernel, unless ``cfg.megakernel`` is off or DVR gradient
    shading or a clip-box interval start ``t_start`` needs the einsum
    lane's per-sample fields."""
    return (cfg.megakernel and not cfg.gradient_shading_dvr
            and t_start is None)


def effective_chunk(grids: LevelGrids, cfg: SlabConfig, height: int,
                    width: int, ky_hints, t_start=None) -> int:
    """Slabs per chunk: on the megakernel lane ``cfg.chunk`` capped by the
    JAX package's rule (its DMA lane's double-buffered VMEM windows had to
    fit ``chunk_budget_mb``); on the einsum lane ``cfg.chunk``.  On the
    card this is no longer a memory cap, but the chunk depth is part of
    the quadrature — adaptive-stride groups form inside a chunk and the
    early exit falls between chunks — so the port keeps the same
    arithmetic and renders the same image."""
    if not megakernel_lane(cfg, t_start):
        return cfg.chunk

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
    """A float32 scalar tensor (keeps every op in float32, as XLA does)."""
    return torch.tensor(np.float32(v), device=device)


def _host_scalar(v) -> torch.Tensor:
    """A float32 scalar on the host for a torch op on the card: the op
    takes it by value, in float32 as one on the card, with no copy to
    the card and no wait."""
    return _f32(v, "cpu")


def ray_components(cam_dir00, cam_du, cam_dv, width: int, height: int,
                   device, lattice=None):
    """Separable ray components in the grid frame, r(i, j) = dir00 +
    (i+.5) du + (j+.5) dv with du along grid x and dv along grid y, or
    taken from ``lattice`` ((W,), (H,)) when given (any monotone separable
    lattice sweeps exactly; shear-warp uses a perspective-adaptive one):
    rx (W,), ry (H,) on ``device``, and sec (H, W) = |r| / |rz|, the
    path length per unit z."""
    d00 = np.asarray(cam_dir00, np.float32)
    if lattice is None:
        i_ = torch.arange(width, dtype=torch.float32) + 0.5
        j_ = torch.arange(height, dtype=torch.float32) + 0.5
        rx = _f32(d00[2], "cpu") + i_ * _f32(np.asarray(cam_du)[2], "cpu")
        ry = _f32(d00[1], "cpu") + j_ * _f32(np.asarray(cam_dv)[1], "cpu")
    else:
        rx, ry = (torch.from_numpy(np.ascontiguousarray(l, np.float32))
                  for l in lattice)
    with profiling.sync("sync.rays", device, 3):
        rx, ry = rx.to(device), ry.to(device)
        rz = _f32(d00[0], device)
    sec = torch.sqrt(ry[:, None] * ry[:, None] + rx[None, :] * rx[None, :]
                     + rz * rz) / torch.abs(rz)
    return rx, ry, sec.contiguous()


def slab_spacing(grids: LevelGrids, nslabs: int) -> np.float32:
    """dz = sweep extent / nslabs, in float32 like the reference."""
    z_lo = np.float32(grids.bounds_lo[0])
    z_hi = np.float32(grids.bounds_hi[0])
    return np.float32((z_hi - z_lo) / np.float32(nslabs))


def scaled_luts(fs, num_channels: int):
    """Per-channel (N, 4) LUTs with the opacity scale folded into alpha
    (host numpy)."""
    scale = np.float32(fs.xf_opacity_scale)
    lut = np.asarray(fs.xf_lut, np.float32)
    return [np.concatenate([lut[c, :, :3], lut[c, :, 3:4] * scale], axis=1)
            for c in range(num_channels)]


def frame_luts(fs, cfg: SlabConfig):
    """The per-channel (N, 4) LUTs a frame classifies (host numpy):
    ``scaled_luts``, resampled linearly to ``cfg.xf_knots`` texels when
    that is not 128 (the JAX package's speed mode, its slabs.py:
    1364-1378: texel positions linspace(0, 127, N), each a lerp of its
    two neighbours)."""
    luts = scaled_luts(fs, cfg.num_channels)
    n = int(cfg.xf_knots)
    if n == NUM_XF_VALUES:
        return luts
    if n < 2:
        raise ValueError(f"xf_knots={n}; the LUT needs at least 2 texels")
    f32 = np.float32
    step = np.arange(n - 1, dtype=f32) / f32(n - 1)
    uu = np.append(f32(NUM_XF_VALUES - 1) * step,
                   f32(NUM_XF_VALUES - 1)).astype(f32)
    k0 = np.clip(np.floor(uu).astype(np.int32), 0, NUM_XF_VALUES - 2)
    fr = (uu - k0.astype(f32))[:, None]
    return [(l[k0] * (f32(1) - fr) + l[k0 + 1] * fr).astype(f32)
            for l in luts]


def xf_texel_coord(value: torch.Tensor, domain,
                   n: int = NUM_XF_VALUES) -> torch.Tensor:
    """value -> clamped texel coordinate in [0, n-1] (lookup_xf,
    exabrick.cu:136-150); ``domain``: the channel's (2,) TF domain."""
    lo, hi = np.asarray(domain, np.float32).reshape(2)
    return texel_coord(value, lo, hi, n)


def _lerp_z(vol, idx, wts):
    """(nz, ny, nx) -> (S, ny, nx): two z planes per slab, weighted."""
    return (wts[0][:, None, None] * vol.index_select(0, idx[0])
            + wts[1][:, None, None] * vol.index_select(0, idx[1]))


def _lerp_x(zl, idx, wts, width: int):
    """(S, ny, nx) -> (S, ny, W): two lattice columns per screen column."""
    s_, ny, _ = zl.shape

    def tap(t):
        cols = idx[t][:, None, :].expand(s_, ny, width)
        return wts[t][:, None, :] * torch.gather(zl, 2, cols)

    return tap(0) + tap(1)


def _lerp_y(xl, idx, wts, height: int):
    """(S, ny, W) -> (S, H, W): two lattice rows per screen row."""
    s_, _, w = xl.shape

    def tap(t):
        rows = idx[t][:, :, None].expand(s_, height, w)
        return wts[t][:, :, None] * torch.gather(xl, 1, rows)

    return tap(0) + tap(1)


def _level_occupancy(grids: LevelGrids, z_planes: torch.Tensor):
    """Per level, (nslabs,) bool on the host: whether a cell of the level
    lies on either z tap of each slab plane (levels that fail add exactly
    0 to the slab's fields and are skipped)."""
    lvl_occ = []
    for li, L in enumerate(grids.levels):
        cw = float(1 << L)
        occz = grids.masks[li].amax(dim=(1, 2))
        with profiling.sync("sync.level_occupancy", occz):
            occz = occz.cpu()
        nz = occz.shape[0]
        qz = z_planes / cw - _f32(grids.origins[li][0], "cpu") - 0.5
        k0 = torch.floor(qz).to(torch.int64)
        o0 = torch.where((k0 >= 0) & (k0 < nz),
                         occz[torch.clamp(k0, 0, nz - 1)], 0.0)
        o1 = torch.where((k0 + 1 >= 0) & (k0 + 1 < nz),
                         occz[torch.clamp(k0 + 1, 0, nz - 1)], 0.0)
        lvl_occ.append((o0 + o1) > 0.0)
    return lvl_occ


class _EinsumLane:
    """One frame's einsum lane (the JAX package's ``chunk_fields`` and its
    classification, slabs.py:1887-1993, 2054-2120).

    One channel without shading (the clip box): per chunk, the live
    slabs' per-level mids (z lerp in torch, x lerp by K6), then K3, which
    does the y lerp, the clip interval's masks and the composite per
    pixel, so no (S, H, W) field is built.  Otherwise: the fields sw,
    swv[c] (S, H, W) at every pixel of every slab, and with gradient
    shading their grid-frame (z, y, x) partials dsw, dswv[c] (3, S, H,
    W), each as the JAX package contracts them — z, then x, then y — but
    as fp32 2-tap lerps where the reference ran dense tent einsums; the
    clip interval's masks on sw; then K4 per channel with the headlight
    shading, the live gate, the channel merge in the reference's order
    and the exclusive-cumprod composite.  Returns the chunk's (rgb (3, H,
    W) premultiplied, trans (H, W))."""

    def __init__(self, grids, cfg, cam_pos, d00, rx, ry, sec, dz, luts,
                 domains, height, width, t_start, t_stop):
        dev = grids.device
        self.grids, self.cfg, self.dev = grids, cfg, dev
        self.h, self.w = height, width
        self.rx, self.ry, self.sec, self.dz = rx, ry, sec, dz
        self.luts, self.domains = luts, domains
        self.oy, self.ox = (_f32(v, dev)
                            for v in np.asarray(cam_pos, np.float32)[1:])

        def per_pixel(t):
            return (None if t is None else torch.as_tensor(
                t, dtype=torch.float32).to(dev).reshape(height,
                                                        width).contiguous())

        self.t_start, self.t_stop = per_pixel(t_start), per_pixel(t_stop)
        if cfg.gradient_shading_dvr:
            # unnormalized ray direction (rz, ry, rx); |L| folds into ndl
            rz = _f32(d00[0], dev)
            self.dirn = torch.stack([rz.expand(height, width),
                                     ry[:, None].expand(height, width),
                                     rx[None, :].expand(height, width)])
            self.dl = torch.sqrt((self.dirn * self.dirn).sum(0))
            self.finest = float(1 << min(grids.levels))

    def fields(self, z_s, occ_s, scale):
        g, dev, h, w = self.grids, self.dev, self.h, self.w
        n_ch = self.cfg.num_channels
        grad = self.cfg.gradient_shading_dvr
        scale_d = scale.to(dev)
        z_d = z_s.to(dev)
        y_pos = self.oy + scale_d[:, None] * self.ry[None, :]  # (S, H)
        x_pos = self.ox + scale_d[:, None] * self.rx[None, :]  # (S, W)

        def zeros(*lead):
            return torch.zeros((*lead, z_s.shape[0], h, w),
                               dtype=torch.float32, device=dev)

        acc = [zeros() for _ in range(1 + n_ch)]  # sw, then swv per channel
        dacc = [zeros(3) for _ in range(1 + n_ch)] if grad else None
        for li, L in enumerate(g.levels):
            if not bool(occ_s[li].any()):
                continue  # no cells near this chunk's slabs on this level
            cw = float(1 << L)
            org = g.origins[li]
            nz, ny, nx = g.masks[li].shape
            iz, wz, dwz = tent_taps(z_d / cw - _f32(org[0], dev) - 0.5, nz)
            iy, wy, dwy = tent_taps(y_pos / cw - _f32(org[1], dev) - 0.5,
                                    ny)
            ix, wx, dwx = tent_taps(x_pos / cw - _f32(org[2], dev) - 0.5,
                                    nx)
            vols = [g.masks[li]] + [g.vals[li][c] for c in range(n_ch)]
            for k, vol in enumerate(vols):
                zl = _lerp_z(vol, iz, wz)
                xl = _lerp_x(zl, ix, wx, w)
                acc[k] = acc[k] + _lerp_y(xl, iy, wy, h)
                if grad:
                    # local-unit derivatives (INV_CELL_WIDTH == 1,
                    # exabrick.cu:641): no 1/cw factor
                    dacc[k] = dacc[k] + torch.stack([
                        _lerp_y(_lerp_x(_lerp_z(vol, iz, dwz), ix, wx, w),
                                iy, wy, h),
                        _lerp_y(xl, iy, dwy, h),
                        _lerp_y(_lerp_x(zl, ix, dwx, w), iy, wy, h)])
        if not grad:
            return acc[0], acc[1:], None, None
        return acc[0], acc[1:], dacc[0], dacc[1:]

    def mids(self, z_s, occ_s, scale):
        """The one-channel unshaded route's z and x stages: per occupied
        level (``occ_s[li].any()``, as ``fields`` skips), in level order,
        the (2, S, ny, W) mids of the value channel and the mask, z-lerped
        in torch (``_lerp_z`` with ``tent_taps``' weights) and x-lerped to
        screen columns by K6 (one launch for every level), and the (S, H,
        4) y taps (w0, w1, r0, r1) of ``tent_taps``, rows as floats: K3's
        inputs, the same lerps ``fields`` runs but for its y stage."""
        g, dev = self.grids, self.dev
        scale_d = scale.to(dev)
        z_d = z_s.to(dev)
        y_pos = self.oy + scale_d[:, None] * self.ry[None, :]  # (S, H)
        x_pos = self.ox + scale_d[:, None] * self.rx[None, :]  # (S, W)
        zvs_l, qx_l, taps_l = [], [], []
        for li, L in enumerate(g.levels):
            if not bool(occ_s[li].any()):
                continue
            cw = float(1 << L)
            org = g.origins[li]
            nz, ny, _ = g.masks[li].shape
            iz, wz, _ = tent_taps(z_d / cw - _f32(org[0], dev) - 0.5, nz)
            (iy0, iy1), (wy0, wy1), _ = tent_taps(
                y_pos / cw - _f32(org[1], dev) - 0.5, ny)
            zvs_l.append(torch.stack([_lerp_z(g.vals[li][0], iz, wz),
                                      _lerp_z(g.masks[li], iz, wz)]))
            qx_l.append((x_pos / cw - _f32(org[2], dev) - 0.5).contiguous())
            taps_l.append(torch.stack([wy0, wy1, iy0.to(torch.float32),
                                       iy1.to(torch.float32)], -1))
        mids = (xresample_mids_levels(zvs_l, qx_l, plain=self.cfg.plain_sweep)
                if zvs_l else [])
        return mids, taps_l

    def chunk(self, z_s, occ_s, scale, live):
        cfg, dev = self.cfg, self.dev
        plain = cfg.plain_sweep
        if cfg.num_channels == 1 and not cfg.gradient_shading_dvr:
            # K3 from the mids of the live slabs: no (S, H, W) field
            keep = live.nonzero().squeeze(1)
            scale_k = scale[keep]
            mids, taps = self.mids(z_s[keep], occ_s, scale_k)
            return composite_mids(mids, taps, scale_k.to(dev),
                                  self.t_start, self.t_stop, self.sec,
                                  self.luts[0], self.domains[0], self.dz,
                                  plain=plain)
        sw, swv, dsw, dswv = self.fields(z_s, occ_s, scale)
        sc = scale.to(dev)[:, None, None]
        if self.t_stop is not None:
            sw = torch.where(sc < self.t_stop[None], sw, 0.0)
        if self.t_start is not None:
            sw = torch.where(sc >= self.t_start[None], sw, 0.0)
        live_d = live.to(dev)
        slab_a = torch.zeros_like(sw)
        slab_rgb = torch.zeros((3,) + tuple(sw.shape), dtype=torch.float32,
                               device=dev)
        take = live_d[:, None, None]
        for c in range(cfg.num_channels):
            r, g, b, a = classify_field(sw, swv[c], self.sec, self.luts[c],
                                        self.domains[c], self.dz,
                                        plain=plain)
            if dsw is not None:
                # headlight shading (integrateVolume, exabrick.cu:
                # 1004-1010): rgb scaled by |L.g|/(|g||L|) where |g| >
                # finest_cw * 1e-6, g the quotient-rule basis gradient
                gv = sw[None] * dswv[c] - swv[c][None] * dsw
                gl = torch.sqrt((gv * gv).sum(0))
                ndl = torch.abs((self.dirn[:, None] * gv).sum(0)) / (
                    torch.clamp(gl * self.dl[None], min=1e-30))
                shade = torch.where(gl > self.finest * 1e-6, ndl, 1.0)
                r, g, b = r * shade, g * shade, b * shade
            contrib = torch.where(take, (1.0 - slab_a) * a, 0.0)
            slab_rgb = slab_rgb + contrib[None] * torch.stack([r, g, b])
            slab_a = slab_a + contrib
        cum = torch.cumprod(1.0 - slab_a, dim=0)
        excl = torch.cat([torch.ones_like(cum[:1]), cum[:-1]])
        return (excl[None] * slab_rgb).sum(dim=1), cum[-1]


class _SyncExit:
    """The einsum lane's exact early exit: at each chunk's top the host
    reads whether every pixel has saturated, waiting for the card."""

    def done(self, alpha) -> bool:
        with profiling.sync("sync.early_exit", alpha):
            return not bool(alpha.min() < TERMINATION_THRESHOLD)

    def flag(self, alpha, ci):
        return None  # K1 runs unflagged


class _FlagExit:
    """The megakernel lane's exact early exit, which never waits for the
    card.  At the top of each chunk it launches, a device flag says
    whether every pixel has alpha >= TERMINATION_THRESHOLD (one entry of
    the frame's flags); K1 reads it, and a set flag makes the chunk an
    exact no-op (rgb 0, transmittance the carried one: ``color + 0`` and
    ``1 - (1 - alpha)`` give the composite back bit for bit, since
    1 - alpha is exact for alpha >= 0.5).  Alpha never falls, so once a
    flag is set every later one is.  The host learns of it without
    waiting: every ``POLL`` launched chunks the flags so far are copied
    to pinned host memory behind an event, and the loop stops at the
    first completed copy that holds a set flag.  The chunks launched from
    the flagged one on change nothing, so the frame is the frame of a
    loop that waited at every chunk's top.

    Counters: ``exit.flagged`` (frames the flag ended) and
    ``exit.late_chunks`` (chunks launched from the first flagged one on,
    which K1 turned into no-ops).  On the CPU the flags are the host's
    and a poll's "copy" is complete at once: the loop stops at the top of
    the chunk after the first poll that follows the flag."""

    # a copy and its event cost ~0.14 ms of host time a chunk in the TF
    # drag's chunk loop on an H100 (PERF.md, Findings); a late chunk
    # costs ~0.5 ms, once, in a frame that saturates
    POLL = 8

    def __init__(self, dev, n_chunks: int):
        self.cuda = dev.type == "cuda"
        self.flags = torch.zeros(n_chunks, dtype=torch.bool, device=dev)
        host = (torch.zeros(n_chunks, dtype=torch.bool, pin_memory=True)
                if self.cuda else self.flags)
        self.host, self.seen = host, host.numpy()
        self.launched = []  # the chunks launched, in order
        self.pending = collections.deque()  # events of copies in flight

    def done(self, alpha) -> bool:
        pending = self.pending
        while pending and (pending[0] is None or pending[0].query()):
            pending.popleft()
            if self.seen.any():
                first = int(self.seen.argmax())
                profiling.count("exit.flagged")
                profiling.count("exit.late_chunks",
                                sum(ci >= first for ci in self.launched))
                return True
        return False

    def flag(self, alpha, ci):
        torch.ge(alpha.min(), TERMINATION_THRESHOLD, out=self.flags[ci])
        self.launched.append(ci)
        if (len(self.launched) - 1) % self.POLL == 0:
            event = None  # the CPU's flags are the host's
            if self.cuda:
                self.host[:ci + 1].copy_(self.flags[:ci + 1],
                                         non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.flags.device))
            self.pending.append(event)
        return self.flags[ci:ci + 1]


def render_slabs(grids: LevelGrids, fs, cfg: SlabConfig, cam_pos, cam_dir00,
                 cam_du, cam_dv, width: int, height: int, knots=None,
                 ky_hints=None, products=None, return_products: bool = False,
                 products_chunks: int = 0, light_rest: bool = False,
                 y_crop=None, lattice=None, t_start=None, t_stop=None,
                 carry=None):
    """Sweep-render one frame (``slabs.render_slabs``).  Camera vectors
    are already permuted to the grid frame (z = sweep axis) and
    separable, or ``lattice`` ((W,), (H,)) gives the lateral ray
    components.  Returns (P, 4) rgba in row-major pixel order.

    ``t_start`` / ``t_stop``: optional (P,) sweep parameters before /
    from which the volume is not integrated (the clip box's interval,
    clipRay exabrick.cu:1258-1264; a surface's hit, integrateVolume's
    t1 = min(t1, surface t)).  ``t_start`` takes the einsum lane, as does
    ``cfg.gradient_shading_dvr`` (``megakernel_lane``); ``t_stop`` alone
    stays on the megakernel lane, where K1 tests it per sample.

    ``carry``: optional (P, 4) premultiplied rgba the sweep starts from
    (an earlier sweep of the slabs in front, its saturation collapse
    off), so this sweep continues that composite as one pass would: its
    early exit and K1's saturation skips see the carried alpha.

    ``return_products=True`` (megakernel lane only) returns the
    per-chunk camera products (the sweep inputs, frame-state
    independent) instead of rendering: a tuple of (ChunkPrep, scale) per
    chunk, or, with ``products_chunks`` > 0 and ``light_rest``,
    {"full": the first M chunks, "light": light entries (no mids) for
    the rest}.  Passing them back as ``products`` renders the frame from
    them — identical output."""
    mega = megakernel_lane(cfg, t_start)
    if return_products and not mega:
        raise ValueError("return_products requires the megakernel lane")
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
    eye = np.asarray(cam_pos, np.float32)
    oz = _f32(eye[0], "cpu")
    oy, ox = _host_scalar(eye[1]), _host_scalar(eye[2])
    order = torch.arange(cfg.nslabs, dtype=f32)
    if cfg.flip:
        order = order.flip(0)
    z_planes = _f32(z_lo, "cpu") + (order + 0.5) * _f32(dz, "cpu")

    lut_np = np.asarray(fs.xf_lut, np.float32)
    dom_np = np.asarray(fs.xf_domain, np.float32)
    with profiling.sync("sync.domains", dev):
        domains = torch.from_numpy(dom_np[:cfg.num_channels]).to(dev)
    # per-slab TF activity (space skipping) on the host: tiny tables
    if cfg.space_skipping:
        with profiling.sync("sync.zranges", grids.zranges):
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
    lut_host = frame_luts(fs, cfg)
    with profiling.sync("sync.luts", dev, len(lut_host)):
        luts = [torch.from_numpy(l).to(dev) for l in lut_host]
    tiles = (cfg.tile_rows, cfg.tile_cols)

    lvl_occ = _level_occupancy(grids, z_planes)
    s_chunk = effective_chunk(grids, cfg, h, w, ky_hints, t_start)
    n_chunks = -(-cfg.nslabs // s_chunk)
    pad = n_chunks * s_chunk - cfg.nslabs
    # pad slab tables to whole chunks (padded slabs inactive, z repeats
    # the last real plane)
    z_planes_p = torch.cat([z_planes, z_planes[-1:].expand(pad)])
    act_p = torch.cat([act, torch.zeros(pad, dtype=torch.bool)])
    lvl_occ_p = [torch.cat([o, torch.zeros(pad, dtype=torch.bool)])
                 for o in lvl_occ]

    # each slab's sweep parameter, elementwise as chunk by chunk
    scale_p = (z_planes_p - oz) / _f32(d00[0], "cpu")
    planes_d = []  # the (2, n_chunks, S) z-plane and scale tables on dev
    orgs_zx = [(_host_scalar(o[0]), _host_scalar(o[2]))
               for o in grids.origins]

    def chunk_tables(ci):
        sl = slice(ci * s_chunk, (ci + 1) * s_chunk)
        return (z_planes_p[sl], [o[sl] for o in lvl_occ_p], scale_p[sl],
                act_p[sl])

    def chunk_planes(ci):
        """Chunk ``ci``'s z planes and scales on the render device, rows
        of tables uploaded once a frame from pinned memory (no wait)."""
        if not planes_d:
            tab = torch.stack([z_planes_p, scale_p]).reshape(2, n_chunks,
                                                             s_chunk)
            if dev.type == "cuda":
                tab = tab.pin_memory().to(dev, non_blocking=True)
            planes_d.append(tab)
        return planes_d[0][0, ci], planes_d[0][1, ci]

    @profiling.in_span("products")
    def mega_chunk_products(ci, occ_s):
        """Camera-only products of chunk ``ci``: per level the (C+1, S,
        ny, W) mids (z 2-tap lerp, then x 2-tap lerp to screen columns)
        and the TF-cull value rows."""
        z_d, scale_d = chunk_planes(ci)
        x_pos = ox + scale_d[:, None] * rx[None, :]  # (S, W)
        zvs_l, qx_l = [], []
        for li, L in enumerate(grids.levels):
            cw = float(1 << L)
            m = grids.masks[li]
            nz = m.shape[0]
            org_z, org_x = orgs_zx[li]
            qz = z_d / cw - org_z - 0.5
            # occupancy gate folded into the z taps (the pipeline is
            # linear): levels with no cells near the chunk contribute 0
            gate = float(bool(occ_s[li].any()))
            k0z = torch.floor(qz).to(torch.int64)
            frz = qz - k0z.to(f32)
            wz0 = gate * torch.where((k0z >= 0) & (k0z < nz), 1.0 - frz, 0.0)
            wz1 = gate * torch.where((k0z + 1 >= 0) & (k0z + 1 < nz),
                                     frz, 0.0)
            i0z = torch.clamp(k0z, 0, nz - 1)
            i1z = torch.clamp(k0z + 1, 0, nz - 1)
            qx = x_pos / cw - org_x - 0.5  # (S, W)
            comps = [grids.vals[li][c] for c in range(cfg.num_channels)]

            def zres(vol):
                return (wz0[:, None, None] * vol.index_select(0, i0z)
                        + wz1[:, None, None] * vol.index_select(0, i1z))

            zvs_l.append(torch.stack([zres(v) for v in comps + [m]]))
            qx_l.append(qx.contiguous())
        # the x stage (K6), one launch for every level and component: the
        # tent entries the JAX package's dense tent matrix holds
        mids = xresample_mids_levels(zvs_l, qx_l, plain=cfg.plain_sweep)
        profiling.count("products.mid_bytes",
                        sum(m.numel() * m.element_size() for m in mids))

        # per-slab (C, S, nyb, 2) value ranges over the z-lerp support
        # rows, for the TF-aware lateral cull
        tf_cull = None
        if grids.vrange_zy and cfg.space_skipping:
            vr_rows = []
            for li, L in enumerate(grids.levels):
                cw = float(1 << L)
                nzl = grids.masks[li].shape[0]
                qz = z_d / cw - orgs_zx[li][0] - 0.5
                k0 = torch.floor(qz).to(torch.int64)
                vr = grids.vrange_zy[li]  # (C, nz, nyb, 2)

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

    def prepare(ci, keep_mids=True):
        _, occ_s, scale, _ = chunk_tables(ci)
        mids, orgs_y, cws_l, tf_cull = mega_chunk_products(ci, occ_s)
        scale_d = chunk_planes(ci)[1]
        y_pos = (oy + scale_d[:, None] * ry[None, :]).contiguous()  # (S, H)
        prep = prepare_chunk(mids, orgs_y, cws_l, y_pos, h, w, tiles=tiles,
                             adaptive_stride=cfg.adaptive_stride,
                             tf_cull=tf_cull)
        return (prep if keep_mids else prep._replace(mids=())), scale

    if return_products:
        n_prep = (n_chunks if products_chunks <= 0
                  else min(n_chunks, products_chunks))
        full = tuple(prepare(ci) for ci in range(n_prep))
        if not (light_rest and n_prep < n_chunks):
            return full
        # light tier: the small camera artifacts (activity tables, TF-cull
        # bounds, positions) of the chunks whose mids do not fit the
        # cache; the frame recomputes only their mids
        light = tuple(prepare(ci, keep_mids=False)
                      for ci in range(n_prep, n_chunks))
        return {"full": full, "light": light}

    full, light = (), ()
    if isinstance(products, dict):
        full, light = products["full"], products["light"]
    elif products is not None:
        full = products
    n_cached = len(full) + len(light)

    tables = pack_luts(luts, domains, knots, dev) if mega else None
    # the surface stop is a per-frame kernel input, never a camera product
    stop_img = (None if t_stop is None or not mega else torch.as_tensor(
        t_stop, dtype=f32).to(dev).reshape(h, w).contiguous())
    lane = None if mega else _EinsumLane(
        grids, cfg, cam_pos, d00, rx, ry, sec, dz, luts, dom_np, h, w,
        t_start, t_stop)
    if carry is None:
        color = torch.zeros((3, h, w), dtype=f32, device=dev)
        alpha = torch.zeros((h, w), dtype=f32, device=dev)
    else:
        carry = torch.as_tensor(carry, dtype=f32).to(dev)
        color = carry[:, :3].T.reshape(3, h, w).contiguous()
        alpha = carry[:, 3].reshape(h, w).contiguous()
    # exact early exit once every pixel saturated: the einsum lane waits
    # for the card at each chunk's top, the megakernel lane never does
    early_exit = _SyncExit() if lane is not None else _FlagExit(dev,
                                                                n_chunks)
    for ci in range(n_chunks):
        with profiling.span("chunk"):
            if early_exit.done(alpha):
                break
            z_s, occ_s, scale, a_s = chunk_tables(ci)
            live = a_s & (scale > 1e-6)
            if not bool(live.any()):
                continue
            if lane is not None:
                rgb, trans = lane.chunk(z_s, occ_s, scale, live)
                # relative merge (no transmittance carry into the chunk)
                color = color + (1.0 - alpha)[None] * rgb
                alpha = 1.0 - (1.0 - alpha) * trans
                continue
            # the camera-product cache tier that serves the chunk
            if ci < len(full):
                profiling.count("cache.full")
                prep = full[ci][0]
            elif ci < n_cached:
                profiling.count("cache.light")
                prep = light[ci - len(full)][0]
                prep = prep._replace(
                    mids=tuple(mega_chunk_products(ci, occ_s)[0]))
            else:
                profiling.count("cache.none")
                prep = prepare(ci)[0]
            done = early_exit.flag(alpha, ci)
            # K7 takes the host's live mask by value and returns it on
            # the card for K1
            act_f, act_all_f, live_f = combine_activity(
                prep, live, luts, domains,
                adaptive_stride=cfg.adaptive_stride, plain=cfg.plain_sweep)
            rgb, trans = run_chunk(
                prep, sec, live_f, tables, dz, h, w, act_f=act_f,
                act_all_f=act_all_f, prev_trans=(1.0 - alpha).contiguous(),
                t_stop=(None if stop_img is None
                        else (chunk_planes(ci)[1], stop_img)),
                tiles=tiles, adaptive_stride=cfg.adaptive_stride,
                done=done, plain=cfg.plain_sweep)
            # absolute-transmittance carry: outputs arrive premultiplied
            color = color + rgb
            alpha = 1.0 - trans

    # saturated pixels collapse to premultiplied opaque (exabrick.cu:1694-97)
    if cfg.saturate_collapse:
        color, alpha = _collapse_saturated(color, alpha)
    rgba = torch.cat([color, alpha[None]], dim=0)  # (4, H, W)
    return rgba.reshape(4, h * w).T


def _collapse_saturated(color: torch.Tensor, alpha: torch.Tensor):
    """Saturated pixels (alpha >= TERMINATION_THRESHOLD) become
    premultiplied opaque; ``color`` carries the channel axis first."""
    sat = alpha >= TERMINATION_THRESHOLD
    color = torch.where(sat[None], color * alpha[None], color)
    alpha = torch.where(sat, 1.0, alpha)
    return color, alpha


def _cache_budget_mb(cfg: SlabConfig, device) -> float:
    """The camera-product cache budget: ``cfg.camera_cache_max_mb``, else
    half the card's memory (the grids and frame buffers need the rest),
    or 4096 MB on the CPU."""
    if cfg.camera_cache_max_mb is not None:
        return float(cfg.camera_cache_max_mb)
    device = torch.device(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return props.total_memory / 2 / 1e6
    return 4096.0


def render_slabs_camera(grids: LevelGrids, fs, cfg: SlabConfig, camera,
                        width: int, height: int, camera_cache=None,
                        lattice=None, t_start=None, t_stop=None,
                        carry=None):
    """Permute/validate the camera, render transposed when pixel x runs
    along grid y, pick the sweep direction from the view sign, crop the
    grids to the rows the rays reach (not on the einsum lane that
    gradient shading or ``cfg.megakernel=False`` choose, as in the JAX
    package), compress the transfer function to knots, and render.
    Returns (P, 4) rgba in row-major pixel order.

    ``lattice``: ((W,), (H,)) lateral ray components of a shear-warp
    intermediate camera (``ShearWarp.lattice``); such a camera supplies
    only its eye and sweep direction and is never swapped.

    ``t_start`` / ``t_stop``: optional (P,) sweep-parameter interval per
    pixel of this render (the clip box, ``renderer.clip_interval``; an
    iso hit's depth as ``t_stop``).  ``t_start`` and
    ``cfg.gradient_shading_dvr`` take the einsum lane; ``t_stop`` alone
    stays on the megakernel lane (K1's surface stop) and its cache.
    ``carry``: optional (P, 4) rgba to continue from (``render_slabs``).

    ``camera_cache``: optional dict owned by the caller (megakernel lane
    only; the einsum lane has no product cache).  The per-chunk camera
    products are computed once per (grids, camera, cfg) key and reused
    at the same pose; when their estimated size exceeds the cache
    budget, a front prefix of chunks is cached in full and the rest as
    light entries (mids recomputed per frame).  The stale pose's products
    are dropped before a rebuild.  Output is identical either way."""
    axis = grids.axis
    if lattice is not None:
        swapped = False
    else:
        mapping = separable_mapping(camera, axis)
        if mapping is None:
            raise ValueError(
                "camera is not separable along the grid sweep axis; "
                "tilted cameras go through render_slabs_shearwarp")
        (swapped,) = mapping
    pos, dir00, du, dv = permute_camera(camera, axis)
    cfg = dataclasses.replace(cfg, flip=bool(dir00[0] < 0))

    mega = megakernel_lane(cfg, t_start)
    y_crop = None
    if cfg.megakernel and not cfg.gradient_shading_dvr:
        y_crop = (y_crop_for_camera(grids, cfg, pos, dir00, du, width)
                  if swapped else
                  y_crop_for_camera(grids, cfg, pos, dir00, dv, height,
                                    lattice=lattice))

    # host-side PWL compression of the transfer function (~10x fewer
    # classification knots for control-point colormaps; the megakernel's)
    knots = (compress_pwl(scaled_luts(fs, cfg.num_channels),
                          fit_tol=cfg.xf_fit_quantum / 255.0)
             if mega and cfg.xf_compress and cfg.xf_knots == NUM_XF_VALUES
             else None)

    def cached_products(pos_, dir00_, du_, dv_, w_, h_, hints):
        if camera_cache is None:
            return None
        camera_cache.pop("tier", None)
        camera_cache.pop("declined", None)
        if not mega:
            return None  # einsum lane: no product cache
        key_cam = tuple(np.asarray(v, np.float64).tobytes()
                        for v in (pos_, dir00_, du_, dv_))
        key_lat = (None if lattice is None else tuple(
            np.asarray(l, np.float32).tobytes() for l in lattice))
        # size gate from the port's own layout: per chunk, per level,
        # (C+1) fp32 mids of (S, ny, W)
        ns_pad = cfg.nslabs + cfg.chunk
        rows_sum = sum(int(m.shape[1]) for m in grids.masks)
        est = ns_pad * rows_sum * w_ * 4 * (1 + cfg.num_channels)
        budget = _cache_budget_mb(cfg, grids.device)
        pc = 0  # 0 = cache every chunk
        if est > budget * 1e6:
            s_eff = effective_chunk(grids, cfg, h_, w_, hints)
            n_act = -(-cfg.nslabs // s_eff)
            m = int(budget * 1e6 // (est / n_act))
            if m < 1:
                camera_cache["declined"] = (
                    f"size: ~{est / 1e6:.0f} MB > cache budget "
                    f"{budget:.0f} MB")
                return None
            pc = m
            camera_cache["tier"] = (
                f"partial: first {m}/{n_act} chunks "
                f"(~{est / n_act * m / 1e6:.0f} of ~{est / 1e6:.0f} MB)"
                f" + light artifacts for the remaining {n_act - m}")
        key = (key_cam, key_lat, w_, h_, cfg, hints, pc, y_crop)
        if (camera_cache.get("key") != key
                or camera_cache.get("grids_ref") is not grids):
            # free the previous pose's products before building the new
            camera_cache.pop("products", None)
            camera_cache.pop("key", None)
            camera_cache["products"] = render_slabs(
                grids, fs, cfg, pos_, dir00_, du_, dv_, w_, h_,
                ky_hints=hints, return_products=True, products_chunks=pc,
                light_rest=bool(pc), y_crop=y_crop, lattice=lattice)
            camera_cache["key"] = key
            camera_cache["grids_ref"] = grids
        return camera_cache["products"]

    if not swapped:
        hints = ky_hints_for_camera(grids, cfg, pos, dir00, dv, height, width,
                                    lattice=lattice)
        products = cached_products(pos, dir00, du, dv, width, height, hints)
        return render_slabs(grids, fs, cfg, pos, dir00, du, dv, width,
                            height, knots=knots, ky_hints=hints,
                            products=products, y_crop=y_crop,
                            lattice=lattice, t_start=t_start, t_stop=t_stop,
                            carry=carry)

    def transposed(t):
        # the internal render is transposed: internal row = final column
        if t is None:
            return None
        t = torch.as_tensor(t)
        return t.reshape(height, width, -1).transpose(0, 1).reshape(t.shape)

    # transposed internals: the v axis is du and the row count is width
    hints = ky_hints_for_camera(grids, cfg, pos, dir00, du, width, height)
    products = cached_products(pos, dir00, dv, du, height, width, hints)
    rgba = render_slabs(grids, fs, cfg, pos, dir00, dv, du, height, width,
                        knots=knots, ky_hints=hints, products=products,
                        y_crop=y_crop, t_start=transposed(t_start),
                        t_stop=transposed(t_stop), carry=transposed(carry))
    return rgba.reshape(width, height, 4).permute(1, 0, 2).reshape(-1, 4)


# ----------------------------------------------------------------------------
# out-of-core z-bands
# ----------------------------------------------------------------------------

# host band grids of the scenes rendered with reuse=True: key -> (the
# bricks' lower array, the scalars, {band: host LevelGrids or None})
_BAND_GRID_CACHE: dict = {}


def _grid_bytes(bricks, channels: int, axis: int) -> int:
    """Bytes of the value and mask grids ``build_level_grids`` builds for
    ``bricks`` (each level cropped to its bricks' box), without
    building them."""
    perm = _perm(axis)
    lo3, hi3 = bricks.bounds()
    total = 0
    for L in np.unique(bricks.level):
        sel = bricks.level == L
        _, (nz, ny, nx) = _level_frame(lo3[sel].min(0), hi3[sel].max(0),
                                       1 << int(L), perm)
        total += (channels + 1) * nz * ny * nx * 4
    return total


def render_slabs_banded(bricks, scalars, fs, cfg: SlabConfig, camera,
                        width: int, height: int, n_bands: int,
                        axis: int = 2, mem_stats=None, reuse: bool = True,
                        device="cuda") -> torch.Tensor:
    """Out-of-core slab sweep (``slabs.render_slabs_banded``) for scenes
    whose dense level grids exceed the card's memory: the sweep axis is
    cut into ``n_bands`` z-bands; each band's grids are built on the
    host from only the bricks whose basis support reaches the band,
    uploaded to ``device``, swept by ``render_slabs_camera`` (K6 and K1
    on the card) with the saturation collapse off, and freed; the bands
    go front to back, each sweep continuing the composite of the bands
    in front (``carry``), and the collapse is applied once at the end.

    Band boundaries lie on the global slab lattice, so the union of the
    bands' slab planes is the single-pass plane set, and the carried
    composite lets each band's early exit and K1's saturation skips act
    as in one pass: the image matches the unbanded render to float
    tolerance.  (The JAX package composites each band from zero, so its
    banded image takes in the light behind saturated tiles that the
    single pass skips.)  Adaptive-stride groups form inside a chunk, so
    with ``adaptive_stride`` the match holds where band boundaries fall
    on the unbanded chunk lattice.  With ``reuse`` (the interactive
    default) the host band grids are scattered once and kept in
    ``_BAND_GRID_CACHE``; later frames pay the upload and the sweep.  A
    band whose every pixel is already saturated ends the sweep (a host
    read per band).

    ``mem_stats``: optional dict given ``peak_band_bytes`` (the largest
    band's value and mask bytes on the device) and ``full_bytes`` (what
    the unbanded grids hold).  Returns (P, 4) rgba on ``device``."""
    dev = render_device(device)
    scalars = np.asarray(scalars, np.float32)
    if scalars.ndim == 1:
        scalars = scalars[None]
    lo3, hi3 = bricks.bounds()
    coarsest = 1 << int(np.max(bricks.level))
    pad = 0.5 * coarsest
    z_lo = float(lo3[:, axis].min()) - pad
    z_hi = float(hi3[:, axis].max()) + pad

    ns_band = -(-cfg.nslabs // n_bands)
    ns_total = ns_band * n_bands
    dz = (z_hi - z_lo) / ns_total

    # brick basis support along the sweep axis (getDomain: bounds +-
    # half the brick's cell width, ExaBricks.h:55-60)
    cw_b = (1 << bricks.level.astype(np.int64)).astype(np.float64)
    b_lo = lo3[:, axis] - 0.5 * cw_b
    b_hi = hi3[:, axis] + 0.5 * cw_b

    _, dir00, _, _ = permute_camera(camera, axis)
    flip = bool(dir00[0] < 0)
    order = range(n_bands - 1, -1, -1) if flip else range(n_bands)

    rgba = torch.zeros((width * height, 4), dtype=torch.float32, device=dev)
    bcfg = dataclasses.replace(cfg, nslabs=ns_band, saturate_collapse=False)

    def build_band(b):
        """Host band grids (CPU tensors), or None for an empty band."""
        zb0 = z_lo + b * ns_band * dz
        zb1 = zb0 + ns_band * dz
        sel = np.nonzero((b_hi > zb0) & (b_lo < zb1))[0]
        if sel.size == 0:
            return None
        sub = type(bricks)(lower=bricks.lower[sel], size=bricks.size[sel],
                           level=bricks.level[sel],
                           begin=bricks.begin[sel])
        gb = build_level_grids(sub, scalars, axis=axis, device="cpu")
        lo_p = np.asarray(gb.bounds_lo).copy()
        hi_p = np.asarray(gb.bounds_hi).copy()
        lo_p[0], hi_p[0] = zb0, zb1
        zr = _compute_zranges(
            list(gb.levels), [v.numpy() for v in gb.vals],
            [m.numpy() for m in gb.masks], list(gb.origins), lo_p, hi_p)
        return dataclasses.replace(gb, bounds_lo=lo_p, bounds_hi=hi_p,
                                   zranges=torch.from_numpy(zr))

    cache_key = (id(bricks.lower), id(scalars) if scalars.base is None
                 else id(scalars.base), n_bands, axis, ns_total)
    hit = _BAND_GRID_CACHE.get(cache_key) if reuse else None
    if hit is not None and hit[0] is bricks.lower:
        bands_host = hit[2]
    else:
        bands_host = {}
        if reuse:
            if len(_BAND_GRID_CACHE) > 8:
                _BAND_GRID_CACHE.clear()
            _BAND_GRID_CACHE[cache_key] = (bricks.lower, scalars,
                                           bands_host)
    if mem_stats is not None:
        mem_stats["full_bytes"] = _grid_bytes(bricks, scalars.shape[0],
                                              axis)

    for b in order:
        if b not in bands_host:
            bands_host[b] = build_band(b)
        gb_host = bands_host[b]
        if gb_host is None:
            continue
        # per-frame cost from here: the upload, the sweep, the free
        gb = gb_host.to(dev)
        if mem_stats is not None:
            band_bytes = nbytes_grids(gb)
            mem_stats["peak_band_bytes"] = max(
                mem_stats.get("peak_band_bytes", 0), band_bytes)
        # front to back: the band's sweep continues the composite of the
        # bands in front
        rgba = render_slabs_camera(gb, fs, bcfg, camera, width, height,
                                   carry=rgba)
        del gb
        if bool(rgba[:, 3].min() >= TERMINATION_THRESHOLD):
            break

    # the reference's saturated-pixel collapse, applied once globally
    color, alpha = _collapse_saturated(rgba[:, :3].T, rgba[:, 3])
    return torch.cat([color, alpha[None]], dim=0).T


def nbytes_grids(grids: LevelGrids) -> int:
    """Bytes of a LevelGrids' value and mask grids."""
    return sum(t.numel() * t.element_size()
               for t in (*grids.vals, *grids.masks))


# ----------------------------------------------------------------------------
# iso surfaces
# ----------------------------------------------------------------------------

def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once, through float64 (XLA's float32
    sqrt is correctly rounded; torch's vectorized CPU one is not)."""
    return torch.sqrt(x.double()).float()


def _iso_fields(grids: LevelGrids, n_ch: int, grad_chs, z_d, y_pos, x_pos,
                occ):
    """The fields of a batch of S slab planes (the JAX package's
    ``_slab_field_ch``, slabs.py:403-475) in its contraction order — z,
    then y, then x — as fp32 2-tap lerps: sw and swv[c], each (S, H, W),
    and with ``grad_chs`` (a set of channels, or None for no gradients)
    dsw and dswv[c] for those channels, each (3, S, H, W), the grid-frame
    (z, y, x) partials in local units.  z_d (S,), y_pos (S, H),
    x_pos (S, W) on the grids' device; occ: per level, whether a cell
    lies on a z tap of any of the S planes (a level without adds 0)."""
    dev = z_d.device
    s_, h = y_pos.shape
    w = x_pos.shape[1]
    comps = [None] + list(range(n_ch))  # the mask, then the channels

    def zeros(*lead):
        return torch.zeros((*lead, s_, h, w), dtype=torch.float32,
                           device=dev)

    acc = [zeros() for _ in comps]
    need = [] if grad_chs is None else [
        k for k, c in enumerate(comps) if c is None or c in grad_chs]
    dacc = {k: zeros(3) for k in need}
    for li, L in enumerate(grids.levels):
        if not occ[li]:
            continue
        cw = float(1 << L)
        org = grids.origins[li]
        nz, ny, nx = grids.masks[li].shape
        iz, wz, dwz = tent_taps(z_d / cw - _f32(org[0], dev) - 0.5, nz)
        iy, wy, dwy = tent_taps(y_pos / cw - _f32(org[1], dev) - 0.5, ny)
        ix, wx, dwx = tent_taps(x_pos / cw - _f32(org[2], dev) - 0.5, nx)
        for k, c in enumerate(comps):
            vol = grids.masks[li] if c is None else grids.vals[li][c]
            zl = _lerp_z(vol, iz, wz)  # (S, ny, nx)
            yl = _lerp_y(zl, iy, wy, h)  # (S, H, nx)
            acc[k] = acc[k] + _lerp_x(yl, ix, wx, w)
            if k in dacc:
                dacc[k] = dacc[k] + torch.stack([
                    _lerp_x(_lerp_y(_lerp_z(vol, iz, dwz), iy, wy, h), ix,
                            wx, w),
                    _lerp_x(_lerp_y(zl, iy, dwy, h), ix, wx, w),
                    _lerp_x(yl, ix, dwx, w)])
    if grad_chs is None:
        return acc[0], acc[1:], None, None
    return acc[0], acc[1:], dacc[0], {c: dacc[1 + c] for c in grad_chs}


def render_slabs_iso(grids: LevelGrids, fs, cfg: SlabConfig, cam_pos,
                     cam_dir00, cam_du, cam_dv, width: int, height: int,
                     return_depth: bool = False, lattice=None,
                     return_normals: bool = False):
    """Slab-sweep implicit iso surfaces (``slabs.render_slabs_iso``,
    IsoSurfaceIntegrationFunction exabrick.cu:1018-1114).  Camera vectors
    are permuted to the grid frame and separable, or ``lattice`` ((W,),
    (H,)) gives the lateral ray components, as in ``render_slabs``.

    Per iso k, the field of channel ``fs.iso_channel[k]`` is tested for a
    sign change between the last valid sample (carried across holes and
    inactive slabs from -1e36) and the current one, slab by slab over the
    slabs whose value range holds an iso value and the slab after each
    (``act | roll(act, 1)``, wrapping as ``jnp.roll`` does).  The hit
    parameter is the distance-weighted crossing (the midpoint on a
    plateau); its color the iso channel's TF at the iso value, or with
    ``cfg.colormap_channel`` != 0 the channel-0 LUT at that channel's
    crossing value (K5, once per frame on the hit image); with
    ``cfg.gradient_shading_iso`` shaded .3 + .7|N.L| by the lerped
    quotient-rule gradient.  The fields are rebuilt per batch of
    ``cfg.chunk`` active slabs (``_iso_fields``); gradients only when the
    shading or ``return_normals`` needs them.

    Returns (P, 4) rgba with alpha 1 at hits; with ``return_depth`` also
    (P,) the sweep parameter of the first hit (inf at misses, render_slabs'
    ``t_stop``); with ``return_normals`` also the (P, 3) face-forward unit
    normals in the grid (z, y, x) frame and the (P,) |dir . N|."""
    f32 = torch.float32
    dev = grids.device
    h, w = height, width
    nc = cfg.num_channels
    ccm = cfg.colormap_channel
    if ccm >= nc:
        raise ValueError("colormap_channel out of range")
    d00 = np.asarray(cam_dir00, np.float32)
    rx, ry, _ = ray_components(cam_dir00, cam_du, cam_dv, w, h, dev,
                               lattice=lattice)
    rz = _f32(d00[0], dev)
    z_lo = np.float32(grids.bounds_lo[0])
    dz = slab_spacing(grids, cfg.nslabs)
    oz, oy, ox = (_f32(v, "cpu") for v in np.asarray(cam_pos, np.float32))
    order = torch.arange(cfg.nslabs, dtype=f32)
    if cfg.flip:
        order = order.flip(0)
    z_planes = _f32(z_lo, "cpu") + (order + 0.5) * _f32(dz, "cpu")
    scale_all = (z_planes - oz) / _f32(d00[0], "cpu")

    # iso activity per slab from the z value-range table, plus the slab
    # after an active span (the crossing shows on the next sample)
    zranges = grids.zranges.cpu()
    zi = torch.clamp((z_planes - _f32(np.floor(z_lo), "cpu")).to(
        torch.int64), 0, zranges.shape[0] - 1)
    vr = zranges[zi]
    iso_on = np.asarray(fs.iso_enabled, bool)
    iso_val = np.asarray(fs.iso_value, np.float32)
    iso_ch = np.asarray(fs.iso_channel).astype(np.int64)
    isos = [k for k in range(iso_on.shape[0]) if iso_on[k]]
    act = torch.zeros(cfg.nslabs, dtype=torch.bool)
    for k in isos:
        v = _f32(iso_val[k], "cpu")
        act = act | ((v >= vr[:, 0]) & (v <= vr[:, 1]))
    act = act | torch.roll(act, 1)

    from .xf import lookup_xf

    # per-iso surface color: the iso channel's TF at the iso value (the
    # field at the weighted crossing is exactly the iso value)
    lut_np = np.asarray(fs.xf_lut, np.float32)
    dom_np = np.asarray(fs.xf_domain, np.float32)
    iso_rgbs = {}
    for k in isos:
        rgb = torch.zeros(3, dtype=f32)
        if 0 <= iso_ch[k] < nc:
            c = int(iso_ch[k])
            rgb = lookup_xf(torch.from_numpy(lut_np[c]),
                            torch.from_numpy(dom_np[c]),
                            _f32(fs.xf_opacity_scale, "cpu"),
                            _f32(iso_val[k], "cpu"))[:3]
        iso_rgbs[k] = rgb.to(dev)[:, None, None]

    # unit ray directions in the grid frame (z, y, x), for the shading
    rnorm = _sqrt_rn(ry[:, None] * ry[:, None] + rx[None, :] * rx[None, :]
                     + rz * rz)
    dirs = (rz / rnorm, ry[:, None] / rnorm, rx[None, :] / rnorm)

    need_grad = cfg.gradient_shading_iso or return_normals
    grad_chs = ({int(iso_ch[k]) for k in isos if 0 <= iso_ch[k] < nc}
                if need_grad else None)
    zero = torch.zeros((h, w), dtype=f32, device=dev)
    prev_vals = [torch.full((h, w), -1e36, dtype=f32, device=dev)
                 for _ in range(nc)]
    prev_grads = {c: torch.zeros((3, h, w), dtype=f32, device=dev)
                  for c in (grad_chs or ())}
    prev_ok = torch.zeros((h, w), dtype=torch.bool, device=dev)
    prev_t = zero
    found = torch.zeros_like(prev_ok)
    color = torch.zeros((3, h, w), dtype=f32, device=dev)
    t_hit = torch.full((h, w), float("inf"), dtype=f32, device=dev)
    hit_n = torch.zeros((3, h, w), dtype=f32, device=dev)
    hit_cos = zero
    # colormap recolor: the crossing value and shade of each pixel's hit;
    # K5 classifies the image once, after the scan
    hit_vcm = zero
    hit_shade = torch.ones((h, w), dtype=f32, device=dev)

    # slabs in front of the eye whose samples can cross (the others leave
    # the carry as it is)
    todo = torch.nonzero(act & (scale_all > 1e-6)).flatten()
    lvl_occ = _level_occupancy(grids, z_planes)
    oy_d, ox_d = oy.to(dev), ox.to(dev)
    for b0 in range(0, todo.numel(), cfg.chunk):
        sel = todo[b0:b0 + cfg.chunk]
        scale = scale_all[sel].to(dev)
        sw, swv, dsw, dswv = _iso_fields(
            grids, nc, grad_chs, z_planes[sel].to(dev),
            oy_d + scale[:, None] * ry[None, :],
            ox_d + scale[:, None] * rx[None, :],
            [bool(o[sel].any()) for o in lvl_occ])
        for j in range(sel.numel()):
            ok = sw[j] > 1e-20
            den = torch.where(ok, sw[j], 1.0)
            vals = [swv[c][j] / den for c in range(nc)]
            grads = {c: torch.stack([sw[j] * dswv[c][a, j]
                                     - swv[c][j] * dsw[a, j]
                                     for a in range(3)])
                     for c in (grad_chs or ())}
            sc = scale[j]
            for k in isos:
                iso = float(iso_val[k])
                ch = int(iso_ch[k])
                vk = vals[ch] if 0 <= ch < nc else zero
                pvk = prev_vals[ch] if 0 <= ch < nc else zero
                cross = (ok & prev_ok & ~found
                         & (((pvk <= iso) & (vk >= iso))
                            | ((pvk >= iso) & (vk <= iso))))
                # distance-weighted crossing (exabrick.cu:1047-1053); a
                # plateau at the iso value takes the midpoint
                d1 = torch.abs(pvk - iso)
                d2 = torch.abs(vk - iso)
                deg = (d1 + d2) <= 0.0
                den_k = torch.clamp(d1 + d2, min=1e-30)
                w1 = torch.where(deg, 0.5, d2 / den_k)
                w2 = torch.where(deg, 0.5, d1 / den_k)
                tavg = prev_t * w1 + sc * w2
                rgb = iso_rgbs[k]
                shade = None
                if need_grad:
                    if 0 <= ch < nc:
                        g = w1[None] * prev_grads[ch] + w2[None] * grads[ch]
                        g = torch.where(torch.isfinite(g), g, 0.0)
                    else:
                        g = torch.zeros((3, h, w), dtype=f32, device=dev)
                    gl = _sqrt_rn(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
                    ndl = torch.abs(dirs[0] * g[0] + dirs[1] * g[1]
                                    + dirs[2] * g[2]) / torch.clamp(
                                        gl, min=1e-30)
                    if cfg.gradient_shading_iso:
                        shade = torch.where(gl > 0.0, 0.3 + 0.7 * ndl, 1.0)
                    if return_normals:
                        n_unit = g / torch.clamp(gl, min=1e-30)[None]
                        # face forward (exabrick.cu:1068-1070)
                        fwd = (dirs[0] * n_unit[0] + dirs[1] * n_unit[1]
                               + dirs[2] * n_unit[2]) > 0.0
                        n_unit = torch.where(fwd[None], -n_unit, n_unit)
                        hit_n = torch.where(cross[None], n_unit, hit_n)
                        hit_cos = torch.where(
                            cross, torch.where(gl > 0.0, ndl, 0.0), hit_cos)
                if ccm != 0:
                    hit_vcm = torch.where(
                        cross, w1 * prev_vals[ccm] + w2 * vals[ccm], hit_vcm)
                    if shade is not None:
                        hit_shade = torch.where(cross, shade, hit_shade)
                else:
                    if shade is not None:
                        rgb = rgb * shade[None]
                    color = torch.where(cross[None], rgb, color)
                t_hit = torch.where(cross, tavg, t_hit)
                found = found | cross
            # last-valid-sample carry across holes and inactive slabs
            prev_vals = [torch.where(ok, v, pv)
                         for v, pv in zip(vals, prev_vals)]
            prev_t = torch.where(ok, sc, prev_t)
            prev_grads = {c: torch.where(ok[None], grads[c], prev_grads[c])
                          for c in prev_grads}
            prev_ok = prev_ok | ok

    if ccm != 0:
        # recolor through the channel-0 LUT (exabrick.cu:1079-1085): K5
        cm_lut = torch.from_numpy(scaled_luts(fs, 1)[0]).to(dev)
        u = xf_texel_coord(hit_vcm, dom_np[0]).contiguous()
        r, g, b, _ = xf_classify(u, cm_lut, plain=cfg.plain_sweep)
        rgb = torch.stack([r, g, b])
        if cfg.gradient_shading_iso:
            rgb = rgb * hit_shade[None]
        color = torch.where(found[None], rgb, color)

    rgba = torch.cat([color, found[None].to(f32)], dim=0)
    out = [rgba.reshape(4, h * w).T]
    if return_depth:
        out.append(t_hit.reshape(h * w))
    if return_normals:
        out.append(hit_n.reshape(3, h * w).T)
        out.append(hit_cos.reshape(h * w))
    return out[0] if len(out) == 1 else tuple(out)


def render_slabs_iso_camera(grids: LevelGrids, fs, cfg: SlabConfig, camera,
                            width: int, height: int, lattice=None,
                            return_normals: bool = False):
    """The iso sweep for a camera (the JAX Renderer's iso block,
    renderer.py:615-648): permute the camera to the grid frame, sweep in
    the view's direction, and render transposed when pixel x runs along
    grid y.  ``lattice`` as in ``render_slabs_camera`` (never swapped).
    Returns (rgba (P, 4), t_iso (P,)) in screen order, and with
    ``return_normals`` also (normals (P, 3) in the grid frame, cos (P,))."""
    if lattice is not None:
        swapped = False
    else:
        mapping = separable_mapping(camera, grids.axis)
        if mapping is None:
            raise ValueError("camera is not separable along the grid sweep "
                             "axis; tilted cameras pass a shear-warp lattice")
        (swapped,) = mapping
    pos, dir00, du, dv = permute_camera(camera, grids.axis)
    cfg = dataclasses.replace(cfg, flip=bool(dir00[0] < 0))
    if not swapped:
        return render_slabs_iso(grids, fs, cfg, pos, dir00, du, dv, width,
                                height, return_depth=True, lattice=lattice,
                                return_normals=return_normals)
    out = render_slabs_iso(grids, fs, cfg, pos, dir00, dv, du, height, width,
                           return_depth=True, return_normals=return_normals)

    def screen(x):  # the internal render is transposed
        tail = tuple(x.shape[1:])
        return x.reshape(width, height, *tail).transpose(0, 1).reshape(
            width * height, *tail)

    return tuple(screen(x) for x in out)

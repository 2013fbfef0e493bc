"""The packed exact DVR (the port of ``owlexabrick_tpu/render/wavefront.py``):
the JAX Renderer's default exact frame.

Two things set it apart from ``dvr.trace_dvr``, and both are kept:

  * point location starts from a dense start grid that maps each
    half-cell macro cell to the deepest BSP node holding it, then
    descends ``descent`` steps over a packed (n_nodes, 12) node table
    (axis, split, child, leaf, box lo, box hi), in place of a full
    ``tree_depth`` descent (``locate_packed``);
  * the basis field is sampled from the dense per-level grids
    (``sample_packed``): per level, trilinear tents over the grid, zero
    outside it, the levels summed in level order.  The dense grids hold
    the cell values the brick basis sum reads, so the field is
    ``sample_basis``'s; only the float32 summation order differs.

The JAX package copies each level into wide "neighbourhood rows"
because a TPU gather costs the same per row at any width.  A Hopper
gather costs by the bytes, so the pack holds the port's own
``LevelGrids`` instead: one flat buffer of every level's value planes
and mask, which the grids' tensors are views of, and a sample step
gathers the 8 corners of every level and channel in one pass.  The
region walk is the port's live-ray walk (``dvr.march_rays``) with the
packed locator and sampler; it marches only live rays, so the JAX
package's compacted orchestrator (``trace_dvr_packed_compacted``) is the
same computation here.  The region and step arithmetic is
``dvr.trace_dvr``'s (exabrick.cu:1116-1185, 1662-1699).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core.constants import TERMINATION_THRESHOLD
from .dvr import (RenderConfig, _dvr_region_done, composite, dvr_setup,
                  march_batches)
from .slabs import LevelGrids


@dataclass(frozen=True)
class WavefrontPack:
    """One scene's point-location tables and sampling grids, on the
    grids' device."""

    # (n_nodes, 12) float32: axis, split, child, leaf, lo (3), hi (3), 0, 0
    node_pack: torch.Tensor
    start_grid: torch.Tensor  # (gz*gy*gx,) int32 start node per macro cell
    grid_org: Tuple[float, float, float]  # corner of cell (0, 0, 0), x y z
    grid_cw: float  # macro cell width
    grid_dims: Tuple[int, int, int]  # (gx, gy, gz)
    descent: int  # bound on the remaining descent depth
    grids: LevelGrids  # axis 2; vals and masks are views into ``flat``
    flat: torch.Tensor  # per level: C value planes, then the mask
    num_channels: int
    # the start grid's origin and last cell (x, y, z) on the device
    grid_org_t: torch.Tensor
    grid_top_t: torch.Tensor
    # per-level sampling tables on the device, x-y-z order like points:
    # 1 / cell width (L,), lattice origin (L, 3), grid size (L, 3) int64,
    # offset of the level's first plane in ``flat`` and cells per plane
    inv_cw: torch.Tensor
    org_xyz: torch.Tensor
    size_xyz: torch.Tensor
    offset: torch.Tensor
    plane: torch.Tensor

    def table_nbytes(self) -> int:
        """Bytes of the point-location tables (node table, start grid);
        the sampling data is the grids' own storage."""
        return sum(t.numel() * t.element_size()
                   for t in (self.node_pack, self.start_grid))


def _subtree_depths(axis, child):
    """Each node's subtree height (0 for a leaf): the JAX package's
    reverse sweep, as a fixed point over all inner nodes at once."""
    depth = np.zeros(axis.shape[0], np.int32)
    inner = np.nonzero(axis < 3)[0]
    c = child[inner].astype(np.int64)
    while inner.size:
        new = 1 + np.maximum(depth[c], depth[c + 1])
        if np.array_equal(new, depth[inner]):
            break
        depth[inner] = new
    return depth


def _start_nodes(axis, split, child, root_lo, cw, dims):
    """The start grid (gz, gy, gx): the deepest node whose half-space
    test holds a whole macro cell, the JAX package's recursive range
    assignment done per cell.  A cell i along the node's axis goes left
    if it lies fully below the split (i < left_end), right if fully above
    (i >= right_start), else stops; the thresholds are computed in the
    float type the JAX loop's scalar expressions take under this numpy."""
    gx, gy, gz = dims
    ft = np.result_type(0.5 - np.float32(0.0))
    a = np.minimum(axis, 2).astype(np.int64)
    x = ((split.astype(ft) - root_lo.astype(ft)[a]) / ft.type(cw))
    left_end = np.floor(x + ft.type(1e-9))
    right_start = np.ceil(x - ft.type(1e-9))
    cz, cy, cx = np.indices((gz, gy, gx), np.int32).reshape(3, -1)
    cell = np.stack([cx, cy, cz], 1)
    node = np.zeros(cx.size, np.int64)
    act = np.arange(cx.size)
    while act.size:
        nd = node[act]
        inner = axis[nd] < 3
        i = cell[act, a[nd]]
        go_l = inner & (i < left_end[nd])
        go_r = inner & (i >= right_start[nd])
        move = go_l | go_r
        node[act[move]] = (child[nd[move]].astype(np.int64)
                           + go_r[move])
        act = act[move]
    return node.reshape(gz, gy, gx).astype(np.int32)


def _level_tables(grids: LevelGrids, device):
    """The flat buffer (per level: C value planes, then the mask), the
    grids rebuilt as views into it, and the per-level sampling
    tables."""
    c = grids.num_channels
    flat = torch.cat([t for v, m in zip(grids.vals, grids.masks)
                      for t in (v.reshape(-1), m.reshape(-1))])
    vals, masks, offs, planes, sizes = [], [], [], [], []
    off = 0
    for m in grids.masks:
        nz, ny, nx = m.shape
        n = nz * ny * nx
        vals.append(flat[off:off + c * n].view(c, nz, ny, nx))
        masks.append(flat[off + c * n:off + (c + 1) * n].view(nz, ny, nx))
        offs.append(off)
        planes.append(n)
        sizes.append((nx, ny, nz))
        off += (c + 1) * n
    views = dataclasses.replace(grids, vals=tuple(vals), masks=tuple(masks))
    inv_cw = torch.tensor([1.0 / (1 << l) for l in grids.levels],
                          dtype=torch.float32, device=device)
    org = np.stack([np.asarray(o, np.float32)[::-1] for o in grids.origins])
    return views, flat, dict(
        inv_cw=inv_cw,
        org_xyz=torch.from_numpy(np.ascontiguousarray(org)).to(device),
        size_xyz=torch.tensor(sizes, dtype=torch.int64, device=device),
        offset=torch.tensor(offs, dtype=torch.int64, device=device),
        plane=torch.tensor(planes, dtype=torch.int64, device=device))


def pack_from_tables(node_pack, start_grid, grid_org, grid_cw, grid_dims,
                     descent, grids: LevelGrids) -> WavefrontPack:
    """A pack from its point-location tables (host arrays) and the
    scene's axis-2 level grids, on the grids' device."""
    if grids.axis != 2:
        raise ValueError("the packed sampler reads axis-2 level grids")
    dev = grids.device
    views, flat, tabs = _level_tables(grids, dev)
    return WavefrontPack(
        node_pack=torch.from_numpy(np.ascontiguousarray(
            np.asarray(node_pack, np.float32))).to(dev),
        start_grid=torch.from_numpy(np.ascontiguousarray(
            np.asarray(start_grid, np.int32).reshape(-1))).to(dev),
        grid_org=tuple(float(x) for x in grid_org), grid_cw=float(grid_cw),
        grid_dims=tuple(int(g) for g in grid_dims), descent=int(descent),
        grid_org_t=torch.tensor(np.asarray(grid_org, np.float32),
                                device=dev),
        grid_top_t=torch.tensor([float(g - 1) for g in grid_dims],
                                dtype=torch.float32, device=dev),
        grids=views, flat=flat, num_channels=grids.num_channels, **tabs)


def build_pack(scene, grids: LevelGrids,
               max_grid_cells: int = 1 << 23) -> WavefrontPack:
    """The pack of a Scene (any device; its BSP is read on the host) and
    its axis-2 LevelGrids, on the grids' device.  The node table and the
    start grid are the JAX ``build_pack``'s bit for bit, and so is the
    refusal: ``ValueError`` past 2^24 node or region ids, which float32
    node rows cannot hold exactly."""
    axis = scene.tree_axis.cpu().numpy()
    split = scene.tree_split.cpu().numpy()
    child = scene.tree_child.cpu().numpy()
    leaf = scene.tree_leaf.cpu().numpy()
    lo = scene.tree_lo.cpu().numpy()
    hi = scene.tree_hi.cpu().numpy()
    n = axis.shape[0]
    if n >= (1 << 24) or leaf.max(initial=0) >= (1 << 24):
        raise ValueError("node/region ids exceed exact float32 range")

    pack = np.zeros((n, 12), np.float32)
    pack[:, 0] = axis
    pack[:, 1] = split
    pack[:, 2] = child
    pack[:, 3] = leaf
    pack[:, 4:7] = lo
    pack[:, 7:10] = hi

    # every region face is a multiple of half the finest cell width
    # (brick domains pad bounds by 0.5 cw, ExaBricks.h:55-60), so a
    # half-cell macro cell straddles no face and the descent left after
    # the start grid is ~0; the width doubles until the grid fits
    root_lo = lo[0]
    root_hi = hi[0]
    ext = np.maximum(root_hi - root_lo, 1e-6)
    cw = 0.5
    while (np.ceil(ext / cw).prod()) > max_grid_cells:
        cw *= 2.0
    gx, gy, gz = (int(np.ceil(ext[a] / cw)) for a in range(3))
    start = _start_nodes(axis, split, child, root_lo, cw, (gx, gy, gz))
    descent = int(_subtree_depths(axis, child)[start].max(initial=0))
    return pack_from_tables(pack, start, root_lo, cw, (gx, gy, gz), descent,
                            grids)


# ----------------------------------------------------------------------------
# point location and sampling
# ----------------------------------------------------------------------------

def locate_packed(pack: WavefrontPack, p: torch.Tensor):
    """(region id (P,) int32, box lo (P, 3), box hi (P, 3)) of points p
    (P, 3): the start grid's node, then ``pack.descent`` steps over the
    node table."""
    gx, gy, _ = pack.grid_dims
    # grid_cw is a power of two: the reciprocal multiply is the division
    ci = torch.minimum(torch.clamp(torch.floor(
        (p - pack.grid_org_t) / pack.grid_cw), min=0.0),
        pack.grid_top_t).to(torch.int64)
    cell = (ci[:, 2] * gy + ci[:, 1]) * gx + ci[:, 0]
    node = pack.start_grid[cell].to(torch.int64)
    row = pack.node_pack[node]
    for _ in range(pack.descent):
        ax = row[:, 0].to(torch.int64)
        pax = p.gather(1, ax.clamp(0, 2)[:, None])[:, 0]
        node = torch.where(ax < 3, row[:, 2].to(torch.int64)
                           + (pax >= row[:, 1]), node)
        row = pack.node_pack[node]
    return row[:, 3].to(torch.int32), row[:, 4:7], row[:, 7:10]


def _planes(pack: WavefrontPack, channels) -> torch.Tensor:
    """The planes a sample gathers: the channels' values, then the mask."""
    return torch.tensor(list(channels) + [pack.num_channels],
                        dtype=torch.int64, device=pack.flat.device)


def _sample_fields(pack: WavefrontPack, pos: torch.Tensor, planes):
    """(ok (P,), values (P, F - 1)) of the basis field at voxel points pos
    (P, 3): every level's 8 corners of the F ``planes`` (``_planes``) in
    one gather; a corner outside its grid weighs 0.  The JAX rows pad
    each level with zeros (to 2 cells in z and y, to whole 16-cell x
    windows) and clip the first corner into the padded grid; a corner
    they move in that way has tent weight 0, so the sum is the one over
    the grid's own cells, zero outside.  Per level the JAX package's
    arithmetic: tents max(0, 1 - |q - k|), the x taps summed first, then
    the (z, y) pairs in its order, then the levels in level order."""
    n_lv = pack.inv_cw.shape[0]
    # lattice coordinates (P, L, 3); 1 / 2^L is exact
    q = pos[:, None, :] * pack.inv_cw[:, None] - pack.org_xyz - 0.5
    k = torch.floor(q)[..., None] + torch.arange(2, dtype=q.dtype,
                                                 device=q.device)
    w = torch.clamp(1.0 - (q[..., None] - k).abs(), min=0.0)  # (P, L, 3, 2)
    ki = k.to(torch.int64)
    size = pack.size_xyz[:, :, None]
    w = torch.where((ki >= 0) & (ki < size), w, 0.0)
    ki = torch.minimum(torch.clamp(ki, min=0), size - 1)
    nx, ny = size[:, 0], size[:, 1]
    # (P, L, 2z, 2y, 2x) corner offsets within a plane
    lin = ((ki[:, :, 2, :, None, None] * ny[:, None, None]
            + ki[:, :, 1, None, :, None]) * nx[:, None, None]
           + ki[:, :, 0, None, None, :])
    base = pack.offset[:, None, None, None] + lin
    idx = base[..., None] + pack.plane[:, None, None, None, None] * planes
    g = pack.flat[idx] * w[:, :, 0, None, None, :, None]  # (P,L,2,2,2,F)
    vdot = g[:, :, :, :, 0] + g[:, :, :, :, 1]  # (P, L, 2z, 2y, F)
    wzy = w[:, :, 2, :, None] * w[:, :, 1, None, :]  # (P, L, 2z, 2y)
    t = (wzy[..., None] * vdot).reshape(pos.shape[0], n_lv, 4, -1)
    lv = ((t[:, :, 0] + t[:, :, 1]) + t[:, :, 2]) + t[:, :, 3]  # (P, L, F)
    acc = lv[:, 0]
    for li in range(1, n_lv):
        acc = acc + lv[:, li]
    sw = acc[:, -1]
    ok = sw > 1e-20
    return ok, acc[:, :-1] / torch.where(ok, sw, 1.0)[:, None]


def sample_packed(pack: WavefrontPack, pos: torch.Tensor, channel: int):
    """(ok (P,), value (P,)) of ``channel``'s basis field at voxel points
    pos (P, 3), from the dense level grids."""
    ok, v = _sample_fields(pack, pos, _planes(pack, (channel,)))
    return ok, v[:, 0]


def packed_batch(pack: WavefrontPack) -> int:
    """Rays marched together: a sample step of n rays builds (n, L, 8,
    C + 1) gather temporaries (an int64 index and float32 corners); the
    batch keeps each near 2^27 elements, so a 1080p frame of a 3-level,
    one-channel scene goes in one batch."""
    n_lv = pack.inv_cw.shape[0]
    return max(1 << 14, (1 << 27) // (8 * n_lv * (pack.num_channels + 1)))


# ----------------------------------------------------------------------------
# the integrator
# ----------------------------------------------------------------------------

def _check_config(cfg: RenderConfig):
    if cfg.gradient_shading_dvr or not cfg.basis_method:
        raise ValueError("packed wavefront supports the default "
                         "basis/no-gradient configuration; use trace_dvr")


def trace_dvr_packed(pack: WavefrontPack, scene, fs, cfg: RenderConfig,
                     o_world, d_world, offset, t_end_world=None,
                     t_start_world=None, batch=None):
    """Volume-integrate rays through the packed locator and sampler
    (``trace_dvr``'s region walk and quadrature), on the scene's device;
    the default feature set only (basis sampling, no gradient shading:
    anything else raises ``ValueError``).  Returns rgba (P, 4).
    ``batch``: rays per batch (default ``packed_batch``)."""
    _check_config(cfg)
    rays, offset, xf, act_mask = dvr_setup(scene, fs, cfg, o_world, d_world,
                                           offset, t_end_world,
                                           t_start_world)
    planes = _planes(pack, range(cfg.num_channels))

    def sample(_rid, _d, _cw, pos, _t, actual_dt, st):
        rgba, = st
        ok, vals = _sample_fields(pack, pos, planes)
        take = ok & (actual_dt != 0.0)
        for c in range(cfg.num_channels):
            s = xf.lookup(c, vals[:, c])
            rgba = composite(rgba, s[:, :3], s[:, 3], take, actual_dt)
        return [rgba], rgba[:, 3] >= TERMINATION_THRESHOLD

    (rgba,), _ = march_batches(
        scene, xf, rays, offset, act_mask, cfg.max_region_iters,
        [torch.zeros((offset.shape[0], 4), dtype=torch.float32,
                     device=offset.device)], sample, _dvr_region_done,
        batch or packed_batch(pack),
        locate=lambda p: locate_packed(pack, p))
    return rgba


def trace_dvr_packed_compacted(pack: WavefrontPack, scene, fs,
                               cfg: RenderConfig, o_world, d_world, offset,
                               t_end_world=None, t_start_world=None,
                               round_iters: int = 16, min_size: int = 8192):
    """The JAX package's binned, compacted packed integrator.  There it
    halves the ray queue every ``round_iters`` region iterations once
    half the rays (down to ``min_size``) finished; the port's walk
    steps only live rays at every iteration, so this is
    ``trace_dvr_packed`` (same frame, bit for bit) and the two queue
    arguments only keep the JAX signature."""
    del round_iters, min_size
    return trace_dvr_packed(pack, scene, fs, cfg, o_world, d_world, offset,
                            t_end_world, t_start_world)

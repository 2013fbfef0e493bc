"""Multi-device modes over ``torch.distributed`` (the port of
``owlexabrick_tpu/parallel/mesh.py``).

The reference scales by replicating buffers/BVHs per GPU and giving each
device its own pixels (OWL multi-device, SURVEY.md "Parallelism").  Each
rank is one process on one device; the caller makes the process group
(``torch.distributed.init_process_group``) and this module spawns
nothing.  The modes, each one program on every rank of the mesh:

  * ``"px"`` x ``"spp"`` (``make_mesh``): pixels sharded, scene
    replicated.  Every rank renders its pixel tile with a jitter/offset
    stream decorrelated along ``spp``; the ``spp`` ranks' images are
    averaged (``all_reduce``) and the ``px`` tiles gathered
    (``all_gather``), so every rank returns the whole image.
  * pixel bands (``make_sharded_slab_renderer``): the slab fast path,
    each ``px`` rank resampling its horizontal band of the image.
  * ``"z"`` bands (``make_band_mesh``): scene sharding.  Each rank holds
    only its z-band's level grids, sweeps it for every pixel from zero
    (the bands run at the same time, so nothing carries from band to
    band), and the partial images combine front to back by a doubling
    prefix of the 'over' operator: log2(D) steps of paired
    ``isend``/``irecv``.

Transport: with the ``gloo`` backend, collectives and point-to-point
messages take CPU tensors, so every exchange is staged through host
memory explicitly (compute stays on each rank's device); that lets
several ranks share one card, which NCCL refuses.  With ``nccl`` (one
card per rank) the tensors go as they are.  ``make_mesh`` and
``make_band_mesh`` log which backend a mesh uses.

Rank layout: a mesh takes the first ``n`` ranks of the world, as the JAX
mesh takes the first ``n`` devices; rank ``r`` sits at px ``r //
n_spp``, spp ``r % n_spp`` (the JAX mesh's row-major device grid), or
at band ``r``.  Ranks past ``n`` are outside the mesh: the renderers
return None there.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.constants import TERMINATION_THRESHOLD
from ..render import prng
from ..render.dvr import RenderConfig, composite_background, trace_dvr
from ..render.slabs import render_device
from ..render.surfaces import trace_surface_pass

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a mesh: ``shape`` ({"px": n, "spp": m} or
    {"z": n}, read as ``mesh.shape["px"]`` as in JAX), this rank's
    ``coords`` along each axis (None outside the mesh), and per axis the
    process group of the ranks that differ from this one only along it,
    with their global ranks in coordinate order."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    groups: Dict[str, object]
    members: Dict[str, tuple]
    device: torch.device
    backend: str

    @property
    def inside(self) -> bool:
        return self.coords is not None


def _rank_device(device) -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` takes card ``rank %
    device_count`` (several ranks share a card when there are fewer)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        render_device(dev)
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return render_device(dev)


def _build_mesh(shape: Dict[str, int], device) -> Mesh:
    """Groups for a row-major grid of ``shape`` over the first ranks; every
    rank makes every group (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make the process group first "
                           "(torch.distributed.init_process_group)")
    axes = list(shape)
    dims = [shape[a] for a in axes]
    n = int(np.prod(dims))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {'x'.join(map(str, dims))} needs {n} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(dims)
    coords = (dict(zip(axes, (int(c) for c in np.unravel_index(rank, dims))))
              if rank < n else None)
    groups, members = {}, {}
    for ai, a in enumerate(axes):
        # every line of the grid along axis a, in a fixed order
        lines = np.moveaxis(grid, ai, -1).reshape(-1, dims[ai])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a], members[a] = g, tuple(ranks)
    backend = dist.get_backend()
    mesh = Mesh(shape=dict(shape), coords=coords, groups=groups,
                members=members, device=_rank_device(device),
                backend=str(backend))
    _log.info("mesh %s over %s: rank %d at %s on %s", mesh.shape,
              mesh.backend, rank, coords, mesh.device)
    return mesh


def make_mesh(n_px: int, n_spp: int = 1, device="cuda") -> Mesh:
    """The px x spp mesh over the first ``n_px * n_spp`` ranks, each on
    ``device`` (a bare ``"cuda"``: card ``rank % device_count``)."""
    return _build_mesh({"px": n_px, "spp": n_spp}, device)


def make_band_mesh(n_bands: int, device="cuda") -> Mesh:
    """The z-band mesh over the first ``n_bands`` ranks."""
    return _build_mesh({"z": n_bands}, device)


# -- transport -------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: gloo moves CPU tensors, so a card's
    tensor is staged through host memory."""
    t = t.contiguous()
    return t.cpu() if mesh.backend == "gloo" else t


def _spp_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """psum over ``spp`` divided by its size (``all_reduce`` SUM)."""
    n_spp = mesh.shape["spp"]
    if n_spp == 1:
        return x
    buf = _wire(mesh, x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.groups["spp"])
    return buf.to(mesh.device) / n_spp


def _gather_px(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The px tiles concatenated in px order (``all_gather``)."""
    if mesh.shape["px"] == 1:
        return x
    buf = _wire(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape["px"])]
    dist.all_gather(parts, buf, group=mesh.groups["px"])
    return torch.cat(parts).to(mesh.device)


# -- px x spp: the exact renderer -------------------------------------------

def _tile_color(scene, fs, surf, cfg, o, d, key, px: int, spp: int):
    """One (px, spp) rank's work: the surface pass and the DVR of its
    pixel tile under the stream ``fold_in(fold_in(key, spp), px)``
    (offsets ``uniform(fold_in(k, 2), (p,))``, the surface key
    ``fold_in(k, 3)``)."""
    k = prng.fold_in(prng.fold_in(key, spp), px)
    offset = prng.uniform(prng.fold_in(k, 2), (o.shape[0],), o.device)
    t_hit, bg = trace_surface_pass(scene, fs, surf, cfg, o, d,
                                   prng.fold_in(k, 3))
    rgba = trace_dvr(scene, fs, cfg, o, d, offset, t_end_world=t_hit)
    return composite_background(rgba, bg)


def make_sharded_renderer(mesh: Mesh, cfg: RenderConfig):
    """The sharded render function of the exact path.

    Returns f(scene, fs, surf, o, d, key) -> (P, 3) linear color on every
    rank of the mesh: ``o``, ``d`` this rank's pixel tile (``shard_rays``),
    ``scene`` and ``surf`` on its device (``replicate``), ``key`` a
    ``prng`` key; the spp ranks' colors averaged, the px tiles gathered.
    """

    def f(scene, fs, surf, o, d, key):
        if not mesh.inside:
            return None
        color = _tile_color(scene, fs, surf, cfg, o, d, key,
                            mesh.coords["px"], mesh.coords["spp"])
        return _gather_px(mesh, _spp_mean(mesh, color))

    return f


def sharded_render_reference(scene, fs, surf, cfg: RenderConfig, o, d, key,
                             n_px: int, n_spp: int = 1):
    """``make_sharded_renderer``'s work in one process: every (px, spp)
    rank's tile in turn, the spp colors summed in spp order and divided
    by their count (the comparison for the mesh)."""
    per = o.shape[0] // n_px
    tiles = []
    for px in range(n_px):
        sl = slice(px * per, (px + 1) * per)
        acc = sum(_tile_color(scene, fs, surf, cfg, o[sl], d[sl], key, px,
                              spp) for spp in range(n_spp))
        tiles.append(acc / n_spp)
    return torch.cat(tiles)


# -- pixel bands: the slab fast path ----------------------------------------

def _band_rgba(grids, fs, cfg, pos, dir00, du, dv, key, width: int,
               rows: int, band: int, spp: int, jitter: bool, knots):
    """One (band, spp) rank's sweep of its ``rows`` image rows: dir00
    shifted to ``dir00 + (band * rows + jy) * dv + jx * du`` with the
    spp rank's sub-pixel jitter ``uniform(fold_in(fold_in(key, spp),
    0|1), ()) - 0.5`` (a shift of the whole pixel grid keeps the sweep
    separable, unlike per-pixel jitter).  No y rows are cropped (neither
    does the JAX mode's ``render_slabs``)."""
    from ..render.slabs import render_slabs

    f32 = np.float32
    if jitter:
        k = prng.fold_in(key, spp)
        jx = prng.uniform_f32(prng.fold_in(k, 0)) - f32(0.5)
        jy = prng.uniform_f32(prng.fold_in(k, 1)) - f32(0.5)
    else:
        jx = jy = f32(0.0)
    dir00_b = (np.asarray(dir00, f32) + f32(band * rows + jy)
               * np.asarray(dv, f32) + jx * np.asarray(du, f32))
    return render_slabs(grids, fs, cfg, pos, dir00_b, du, dv, width, rows,
                        knots=knots)


def _band_rows(height: int, n_px: int) -> int:
    if height % n_px != 0:
        raise ValueError(f"height {height} not divisible by px={n_px}")
    return height // n_px


def make_sharded_slab_renderer(mesh: Mesh, cfg, width: int, height: int,
                               jitter: bool = True):
    """Pixel-band sharding for the slab fast path: each rank along "px"
    sweeps the same slabs but resamples only its horizontal band of the
    image (the per-band rays stay separable: the band offset is a shift of
    dir00 along dv).  Ranks along "spp" render decorrelated sub-pixel
    offsets, averaged.

    Returns f(grids, fs, pos, dir00, du, dv, key[, knots]) -> (H*W, 4)
    rgba on every rank of the mesh; ``grids`` on this rank's device,
    camera vectors permuted to the grid frame, ``key`` a ``prng`` key,
    ``knots`` from ``compress_pwl``."""
    rows = _band_rows(height, mesh.shape["px"])

    def f(grids, fs, pos, dir00, du, dv, key, knots=None):
        if not mesh.inside:
            return None
        rgba = _band_rgba(grids, fs, cfg, pos, dir00, du, dv, key, width,
                          rows, mesh.coords["px"], mesh.coords["spp"],
                          jitter, knots)
        return _gather_px(mesh, _spp_mean(mesh, rgba))

    return f


def sharded_slab_reference(grids, fs, cfg, pos, dir00, du, dv, key,
                           width: int, height: int, n_px: int,
                           n_spp: int = 1, jitter: bool = True, knots=None):
    """``make_sharded_slab_renderer``'s work in one process: every band
    and spp rank's sweep in turn, averaged over spp in spp order."""
    rows = _band_rows(height, n_px)
    bands = []
    for band in range(n_px):
        acc = sum(_band_rgba(grids, fs, cfg, pos, dir00, du, dv, key, width,
                             rows, band, spp, jitter, knots)
                  for spp in range(n_spp))
        bands.append(acc / n_spp)
    return torch.cat(bands)


# -- z bands: scene sharding ------------------------------------------------

def build_band_grids(bricks, scalars, n_bands: int, nslabs: int,
                     axis: int = 2):
    """Partition the sweep axis into ``n_bands`` equal z-bands on the
    global slab lattice (the same partitioning as render_slabs_banded)
    and build per-band level grids on the host, padded to common shapes
    and stacked with a leading band axis.

    Returns (stacked, meta): ``stacked`` a dict of band-major host numpy
    arrays (vals/masks/origins per level, bounds, zranges); ``meta`` the
    static fields (levels, ns_band, the band's z extent, channels, axis).
    """
    from ..core.types import Bricks
    from ..render.slabs import _compute_zranges, build_level_grids

    scalars = np.asarray(scalars, np.float32)
    if scalars.ndim == 1:
        scalars = scalars[None]
    lo3, hi3 = bricks.bounds()
    coarsest = 1 << int(np.max(bricks.level))
    pad = 0.5 * coarsest
    z_lo = float(lo3[:, axis].min()) - pad
    z_hi = float(hi3[:, axis].max()) + pad
    ns_band = -(-nslabs // n_bands)
    dz = (z_hi - z_lo) / (ns_band * n_bands)

    cw_b = (1 << bricks.level).astype(np.float64)
    b_lo = lo3[:, axis] - 0.5 * cw_b
    b_hi = hi3[:, axis] + 0.5 * cw_b

    levels_all = tuple(sorted(int(l) for l in np.unique(bricks.level)))
    per_band = []
    for b in range(n_bands):
        zb0 = z_lo + b * ns_band * dz
        zb1 = zb0 + ns_band * dz
        sel = np.nonzero((b_hi > zb0) & (b_lo < zb1))[0]
        if sel.size == 0:
            per_band.append(None)
            continue
        sub = Bricks(
            lower=bricks.lower[sel], size=bricks.size[sel],
            level=bricks.level[sel], begin=bricks.begin[sel],
        )
        gb = build_level_grids(sub, scalars, axis=axis, device="cpu")
        vals = [v.numpy() for v in gb.vals]
        masks = [m.numpy() for m in gb.masks]
        lo_p = np.asarray(gb.bounds_lo).copy()
        hi_p = np.asarray(gb.bounds_hi).copy()
        lo_p[0], hi_p[0] = zb0, zb1
        zr = _compute_zranges(list(gb.levels), vals, masks,
                              [np.asarray(o) for o in gb.origins], lo_p,
                              hi_p)
        per_band.append(dict(levels=gb.levels, vals=vals, masks=masks,
                             origins=gb.origins, zranges=zr, bounds_lo=lo_p,
                             bounds_hi=hi_p))

    # common padded dims per global level
    dims = {}
    nzf_max = 1
    c = scalars.shape[0]
    for gb in per_band:
        if gb is None:
            continue
        nzf_max = max(nzf_max, gb["zranges"].shape[0])
        for L, v in zip(gb["levels"], gb["vals"]):
            d3 = tuple(int(s) for s in v.shape[1:])
            prev = dims.get(L, (1, 1, 1))
            dims[L] = tuple(max(a, b) for a, b in zip(prev, d3))
    for L in levels_all:
        dims.setdefault(L, (1, 1, 1))

    def pad_to(a, shape):
        out = np.zeros(shape, np.float32)
        sl = tuple(slice(0, s) for s in a.shape)
        out[sl] = a
        return out

    def empty_zranges(n):
        return np.stack([np.full(n, np.inf, np.float32),
                         np.full(n, -np.inf, np.float32)], axis=1)

    stacked = {"vals": [], "masks": [], "origins": [], "zranges": [],
               "bounds_lo": [], "bounds_hi": []}
    for L in levels_all:
        nz, ny, nx = dims[L]
        vs, ms, os_ = [], [], []
        for gb in per_band:
            if gb is not None and L in gb["levels"]:
                li = gb["levels"].index(L)
                vs.append(pad_to(gb["vals"][li], (c, nz, ny, nx)))
                ms.append(pad_to(gb["masks"][li], (nz, ny, nx)))
                os_.append(np.asarray(gb["origins"][li], np.float32))
            else:
                vs.append(np.zeros((c, nz, ny, nx), np.float32))
                ms.append(np.zeros((nz, ny, nx), np.float32))
                os_.append(np.zeros(3, np.float32))
        stacked["vals"].append(np.stack(vs))
        stacked["masks"].append(np.stack(ms))
        stacked["origins"].append(np.stack(os_))
    for b, gb in enumerate(per_band):
        zb0 = z_lo + b * ns_band * dz
        zb1 = zb0 + ns_band * dz
        if gb is None:
            zr = empty_zranges(nzf_max)
            blo = np.asarray([zb0, 0.0, 0.0], np.float32)
            bhi = np.asarray([zb1, 1.0, 1.0], np.float32)
        else:
            zr = gb["zranges"]
            padn = nzf_max - zr.shape[0]
            if padn:
                zr = np.concatenate([zr, empty_zranges(padn)])
            blo, bhi = gb["bounds_lo"], gb["bounds_hi"]
        stacked["zranges"].append(zr)
        stacked["bounds_lo"].append(blo)
        stacked["bounds_hi"].append(bhi)
    for k in ("zranges", "bounds_lo", "bounds_hi"):
        stacked[k] = np.stack(stacked[k])

    meta = {
        "levels": levels_all,
        "ns_band": ns_band,
        "extent_band": float(ns_band * dz),
        "num_channels": c,
        "axis": axis,
    }
    return stacked, meta


def shard_bands(mesh: Mesh, stacked):
    """This rank's band of ``build_band_grids``'s stack on its device:
    the same dict without the band axis.  Only this band reaches the
    device, never the whole stack (None outside the mesh)."""
    if not mesh.inside:
        return None
    return band_of(stacked, mesh.coords["z"], mesh.device)


def band_of(stacked, b: int, device):
    """Band ``b`` of ``build_band_grids``'s stack on ``device``, as
    ``shard_bands`` places it."""

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a[b])).to(device)

    return {
        "vals": [dev(v) for v in stacked["vals"]],
        "masks": [dev(m) for m in stacked["masks"]],
        "origins": [np.asarray(o[b], np.float32) for o in stacked["origins"]],
        "zranges": dev(stacked["zranges"]),
        "bounds_lo": np.asarray(stacked["bounds_lo"][b], np.float32),
        "bounds_hi": np.asarray(stacked["bounds_hi"][b], np.float32),
    }


def _band_partial(band, fs, cfg, meta, pos, dir00, du, dv, width: int,
                  height: int):
    """One z rank's sweep of its band from zero, the saturation collapse
    left to the combiner: (color (P, 3), alpha (P,))."""
    from ..render.slabs import LevelGrids, render_slabs

    g = LevelGrids(
        vals=tuple(band["vals"]), masks=tuple(band["masks"]),
        origins=tuple(band["origins"]), zranges=band["zranges"],
        bounds_lo=band["bounds_lo"], bounds_hi=band["bounds_hi"],
        vrange_zy=(), levels=meta["levels"],
        num_channels=meta["num_channels"], axis=meta["axis"], y_bin=())
    bcfg = dataclasses.replace(cfg, nslabs=meta["ns_band"],
                               saturate_collapse=False)
    rgba = render_slabs(g, fs, bcfg, pos, dir00, du, dv, width, height)
    return rgba[:, :3], rgba[:, 3]


def _over(front, back):
    """'over' of two partial images, ``front`` in front of ``back``."""
    rc, ra = front
    color, alpha = back
    return rc + (1.0 - ra)[:, None] * color, ra + (1.0 - ra) * alpha


def _collapse(color, alpha):
    """The reference's saturated-pixel collapse, applied once, as (P, 4)."""
    sat = alpha >= TERMINATION_THRESHOLD
    color = torch.where(sat[:, None], color * alpha[:, None], color)
    alpha = torch.where(sat, torch.ones_like(alpha), alpha)
    return torch.cat([color, alpha[:, None]], 1)


def _prefix_pairs(n_bands: int, flip: bool):
    """The doubling prefix's steps: per step k (1, 2, 4, ...) the
    (source, destination) band pairs; band 0 is nearest unless
    ``flip``."""
    step = -1 if flip else 1
    k, steps = 1, []
    while k < n_bands:
        steps.append([(i, i + step * k) for i in range(n_bands)
                      if 0 <= i + step * k < n_bands])
        k *= 2
    return steps


def make_band_sharded_slab_renderer(mesh: Mesh, cfg, meta, width: int,
                                    height: int):
    """Scene-sharded rendering: each rank along the ``"z"`` mesh axis
    holds only its z-band's level grids (the device-resident analog of
    render_slabs_banded) and sweeps its band for ALL pixels from zero;
    partial (color, alpha) images are combined front-to-back with a
    doubling parallel prefix of the 'over' operator, log2(D) steps of
    paired isend/irecv (a rank with no partner receives zeros, the
    identity of 'over'), then the saturated-pixel collapse once.

    Returns f(band, fs, pos, dir00, du, dv) -> (H*W, 4) rgba on every
    rank of the mesh: the back-most band's prefix in traversal order,
    broadcast.  ``band``: this rank's ``shard_bands``; camera vectors
    permuted to the grid frame and separable."""
    n_bands = mesh.shape["z"]
    members = mesh.members.get("z", ())

    def f(band, fs, pos, dir00, du, dv):
        if not mesh.inside:
            return None
        color, alpha = _band_partial(band, fs, cfg, meta, pos, dir00, du,
                                     dv, width, height)
        i = mesh.coords["z"]
        for pairs in _prefix_pairs(n_bands, cfg.flip):
            send = _wire(mesh, torch.cat([color, alpha[:, None]], 1))
            recv = torch.zeros_like(send)
            reqs = [dist.isend(send, members[dst])
                    for src, dst in pairs if src == i]
            reqs += [dist.irecv(recv, members[src])
                     for src, dst in pairs if dst == i]
            for r in reqs:
                r.wait()
            recv = recv.to(mesh.device)
            # the received prefix is IN FRONT of ours
            color, alpha = _over((recv[:, :3], recv[:, 3]), (color, alpha))
        out = _wire(mesh, _collapse(color, alpha))
        back = (n_bands - 1) if not cfg.flip else 0
        dist.broadcast(out, members[back], group=mesh.groups["z"])
        return out.to(mesh.device)

    return f


def band_sharded_reference(bands, fs, cfg, meta, pos, dir00, du, dv,
                           width: int, height: int):
    """``make_band_sharded_slab_renderer``'s work in one process: the
    bands (``shard_bands`` of each band, in band order) swept one after
    another from zero and combined by the same doubling prefix."""
    parts = [_band_partial(b, fs, cfg, meta, pos, dir00, du, dv, width,
                           height) for b in bands]
    for pairs in _prefix_pairs(len(bands), cfg.flip):
        recv = {dst: parts[src] for src, dst in pairs}
        parts = [_over(recv[i], parts[i]) if i in recv else parts[i]
                 for i in range(len(parts))]
    back = (len(bands) - 1) if not cfg.flip else 0
    return _collapse(*parts[back])


# -- placement ---------------------------------------------------------------

def shard_rays(mesh: Mesh, o, d):
    """This rank's pixel tile of the (P, 3) rays, on its device (None
    outside the mesh)."""
    if not mesh.inside:
        return None, None
    n_px = mesh.shape["px"]
    p = o.shape[0]
    if p % n_px:
        raise ValueError(f"{p} rays not divisible by px={n_px}")
    per = p // n_px
    sl = slice(mesh.coords["px"] * per, (mesh.coords["px"] + 1) * per)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a)[sl]),
                               dtype=torch.float32).to(mesh.device)

    return dev(o), dev(d)


def replicate(mesh: Mesh, tree):
    """``tree`` on this rank's device: a tensor, an object with ``.to``
    (Scene, LevelGrids) or a dict / list / tuple / dataclass of them
    (SurfaceData) moves; numpy leaves stay on the host (FrameState is
    host numpy by design)."""
    dev = mesh.device
    if isinstance(tree, torch.Tensor) or hasattr(tree, "to"):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(mesh, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree

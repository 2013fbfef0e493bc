"""Slab-sweep stage of one chunk: y-interpolation + classification +
front-to-back compositing (the port of ``owlexabrick_tpu/render/
pallas_sweep.py``, default megakernel lane only, with its surface stop).

Per chunk of S slabs the work splits in three, as in the JAX package, so
a static camera pose can cache everything camera-dependent:

* ``prepare_chunk`` (camera only): the geometric per-(slab, row-tile,
  column-tile) activity tables from mask support, and the TF-cull value
  bounds per (slab, row tile).
* ``combine_activity`` (per frame, tiny): TF/live masks and the
  adaptive-stride step weights.  For CUDA tensors it launches K7 in
  ``csrc/sweep.cu``, one launch a chunk; for CPU tensors it runs
  ``combine_activity_reference``, the same function in plain torch.
* ``run_chunk``: the sweep itself.  For CUDA tensors it launches K1, the
  hand-written Hopper kernel in ``csrc/sweep.cu``; for CPU tensors it
  runs ``sweep_chunk_reference``, the same function in plain torch.

The mids arrive as one fp32 tensor per level, ``(C+1, S, ny, W)``:
channel mids then the mask mid, x-resampled to screen columns and
z-lerped at the chunk's slab planes.  None of the TPU layout survives
(no 8-row/128-lane padding, no ``(n_ct, S, ny, tc)`` stack, no bf16
hi/lo split, no window DMA).  What stays is the reference's tile shape
(``tile_shape``): the activity tables, the adaptive-stride groups and
the 0.005 per-tile saturation skip are per tile, so the tile decides
the quadrature, not only the speed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constants import MAX_CHANNELS
from ..utils import profiling
from .xf import active_for_volume_sampling


def tile_shape(height: int, width: int, tiles=(0, 0),
               adaptive_stride: bool = False) -> Tuple[int, int]:
    """The sweep's (rows, cols) tile shape, unchanged from the JAX
    package (``pallas_sweep.tile_shape``): tr = the largest multiple-of-8
    divisor of height up to 256 (1080 -> 216), else the largest tile
    whose row padding stays under 12.5% (8 for small frames); tc = the
    first of 512, 256, 128 dividing width, else 128.
    ``SlabConfig.tile_rows/tile_cols`` override."""
    tr_cap = 256
    tr = tiles[0] or max(
        (t for t in range(8, tr_cap + 1, 8) if height % t == 0), default=0
    )
    if tr == 0:
        tr = 8
        if height >= 128:
            for t in range(8, tr_cap + 1, 8):
                if (-(-height // t) * t - height) * 8 <= height:
                    tr = t
    tc = tiles[1] or next(
        (t for t in (512, 256, 128) if width % t == 0), 128
    )
    return tr, tc


class ChunkPrep(NamedTuple):
    """Camera-only sweep inputs for one chunk (frame-state independent,
    so a static pose computes them once).

    mids: per level (C+1, S, ny, W) fp32 — () for a light-tier entry,
    whose mids are recomputed per frame.
    origins_y / cell_widths: per-level host floats.
    acts_l: (L, S, R, Ct) bool geometric tile activity from mask support.
    vmin / vmax: optional (C, S, R) blended-value bounds for the TF cull.
    y_pos: (S, H) slab-plane y coordinates."""

    mids: tuple
    origins_y: tuple
    cell_widths: tuple
    acts_l: torch.Tensor
    vmin: Optional[torch.Tensor]
    vmax: Optional[torch.Tensor]
    y_pos: torch.Tensor


@profiling.in_span("tiles")
def prepare_chunk(mids: Sequence[torch.Tensor], origins_y, cell_widths,
                  y_pos: torch.Tensor, height: int, width: int, *,
                  tiles=(0, 0), adaptive_stride: bool = False,
                  tf_cull=None) -> ChunkPrep:
    """Geometric tile activity and TF-cull bounds for one chunk
    (``pallas_sweep.prepare_chunk:1366-1458``, same formulas in the same
    order so every floor lands on the same side)."""
    s_ = y_pos.shape[0]
    dev = y_pos.device
    tr, tc = tile_shape(height, width, tiles, adaptive_stride)
    n_ct = -(-width // tc)
    n_rt = -(-height // tr)
    pad_r = n_rt * tr - height
    pad_c = n_ct * tc - width
    ypp = y_pos if pad_r == 0 else torch.cat(
        [y_pos, y_pos[:, -1:].expand(s_, pad_r)], dim=1)
    yt = ypp.reshape(s_, n_rt, tr)
    y_lo_t = yt.amin(-1)  # (S, R)
    y_hi_t = yt.amax(-1)

    # lateral space skipping: a slab's cells can only reach a tile whose
    # y range overlaps an occupied lattice row's tent support and whose
    # columns hold non-zero x-resampled mask
    acts_l = []
    for li, m in enumerate(mids):
        mm = m[-1]  # (S, ny, W) mask mid
        ny = mm.shape[1]
        occ = mm > 0
        if pad_c:
            occ = torch.nn.functional.pad(occ, (0, pad_c))
        occ = occ.reshape(s_, ny, n_ct, tc).any(-1)  # (S, ny, Ct)
        cs = torch.cumsum(occ.to(torch.int32), dim=1)
        cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
        cw = float(cell_widths[li])
        org = float(origins_y[li])
        qlo = y_lo_t / cw - org - 0.5  # (S, R)
        qhi = y_hi_t / cw - org - 0.5
        k0 = torch.clamp(torch.floor(qlo).to(torch.int64) - 1, 0, ny)
        k1 = torch.clamp(torch.floor(qhi).to(torch.int64) + 2, 0, ny)
        lo_g = torch.gather(cs, 1, k0[:, :, None].expand(s_, n_rt, n_ct))
        hi_g = torch.gather(cs, 1, k1[:, :, None].expand(s_, n_rt, n_ct))
        acts_l.append(hi_g - lo_g > 0)

    vmin_all = vmax_all = None
    if tf_cull is not None:
        # the blended value at any point is a convex combination of the
        # contributing cell values, so the min/max over every level's
        # support rows bounds it (the lateral analog of the reference's
        # TF-culled bounds program, exabrick.cu:283-331)
        vr_rows, y_bins = tf_cull
        n_ch = vr_rows[0].shape[0]
        vmin_all = torch.full((n_ch, s_, n_rt), float("inf"), device=dev)
        vmax_all = torch.full((n_ch, s_, n_rt), float("-inf"), device=dev)
        for li, vr_s in enumerate(vr_rows):  # (C, S, nyb, 2)
            nyb = vr_s.shape[2]
            bin_ = float(y_bins[li])
            cw = float(cell_widths[li])
            org = float(origins_y[li])
            qlo = y_lo_t / cw - org - 0.5 - 1.0  # (S, R)
            qhi = y_hi_t / cw - org - 0.5 + 1.0
            b0 = torch.floor(qlo / bin_)
            b1 = torch.floor(qhi / bin_)
            bidx = torch.arange(nyb, dtype=torch.float32, device=dev)
            inr = (bidx >= b0[..., None]) & (bidx <= b1[..., None])
            vmin_all = torch.minimum(vmin_all, torch.where(
                inr[None], vr_s[:, :, None, :, 0], float("inf")).amin(-1))
            vmax_all = torch.maximum(vmax_all, torch.where(
                inr[None], vr_s[:, :, None, :, 1], float("-inf")).amax(-1))

    return ChunkPrep(
        mids=tuple(mids), origins_y=tuple(float(o) for o in origins_y),
        cell_widths=tuple(float(c) for c in cell_widths),
        acts_l=torch.stack(acts_l), vmin=vmin_all, vmax=vmax_all,
        y_pos=y_pos,
    )


def combine_activity_reference(prep: ChunkPrep, live: torch.Tensor, luts,
                               domains, *, adaptive_stride: bool = False):
    """Plain-torch K7: per-frame (TF/live-dependent) activity tables from
    the cached geometric ones (``pallas_sweep.combine_activity:1489-1579``):
    OR the per-level activities, mask dead slabs, apply the TF-aware
    lateral cull, then form the adaptive-stride step weights.  ``live``:
    (S,) bool on the tables' device.  Returns (act_f (S, R, Ct), act_all_f
    (R, Ct)) fp32."""
    acts_l = prep.acts_l
    _, s_, n_rt, n_ct = acts_l.shape
    dev = acts_l.device
    inf = float("inf")
    with profiling.sync("sync.cell_widths", dev):
        cws = torch.tensor(prep.cell_widths, dtype=torch.float32,
                           device=dev)
    act = acts_l.any(0) & live[:, None, None]

    if prep.vmin is not None:
        act_tf = torch.zeros((s_, n_rt), dtype=torch.bool, device=dev)
        for ch in range(prep.vmin.shape[0]):
            rng = torch.stack([prep.vmin[ch], prep.vmax[ch]], -1)
            a = active_for_volume_sampling(luts[ch], domains[ch], 1.0, rng)
            act_tf = act_tf | (a & (prep.vmax[ch] >= prep.vmin[ch]))
        act = act & act_tf[:, :, None]

    act_f = act.to(torch.float32)
    if adaptive_stride and s_ > 1:
        # adaptive z-stride (the slab form of the reference's per-region
        # dt = global_dt * finestLevelCellWidth, exabrick.cu:1129): where
        # a tile's finest contributing level is coarse, one slab stands
        # in for a group of up to 8, formed greedily (8, 4, then 2)
        cw_act = torch.full((s_, n_rt, n_ct), inf, device=dev)
        for li in range(acts_l.shape[0]):
            cw_act = torch.minimum(
                cw_act, torch.where(acts_l[li], cws[li], inf))
        lim = torch.where(act, cw_act / cws.min(), inf)
        weight = act.to(torch.float32)
        consumed = torch.zeros((s_, n_rt, n_ct), dtype=torch.bool,
                               device=dev)
        for c_val in (8, 4, 2):
            if c_val > s_:
                continue
            gpad = (-s_) % c_val

            def grouped(x, fill, c_val=c_val, gpad=gpad):
                if gpad:
                    x = torch.cat([x, torch.full(
                        (gpad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                        device=dev)])
                return x.reshape(-1, c_val, n_rt, n_ct)

            gl = grouped(lim, inf)
            ga = grouped(act, False)
            gc = grouped(consumed, False)
            feas = ((gl.amin(1) >= c_val) & (ga.sum(1) >= 2)
                    & ~gc.any(1))  # (G, R, Ct)
            # representative = active slab nearest the active span middle
            li_ = torch.arange(c_val, dtype=torch.float32,
                               device=dev)[None, :, None, None]
            first = torch.where(ga, li_, float(c_val)).amin(1)
            last = torch.where(ga, li_, -1.0).amax(1)
            mid = 0.5 * (first + last)
            score = torch.abs(li_ - mid[:, None]) + torch.where(
                ga, 0.0, 1e9)
            rep = torch.argmin(score, dim=1)  # (G, R, Ct), first minimum
            is_rep = li_.to(torch.int64) == rep[:, None]
            cnt = ga.sum(1).to(torch.float32)[:, None]
            w_g = torch.where(is_rep & ga, cnt, 0.0)
            apply = feas[:, None] & ga
            gw = torch.where(apply, w_g, grouped(weight, 0.0))
            gcon = torch.where(feas[:, None], True, gc)
            weight = gw.reshape(-1, n_rt, n_ct)[:s_]
            consumed = gcon.reshape(-1, n_rt, n_ct)[:s_]
        act_f = weight
    # per tile "every slab active at unit weight"
    act_all_f = (act.all(0) & (torch.abs(act_f - 1.0) < 0.5).all(0)).to(
        torch.float32)
    return act_f.contiguous(), act_all_f.contiguous()


def _k7_packs(prep: ChunkPrep, live, n_texels: int,
              adaptive_stride: bool):
    """K7's int and float argument packs (``csrc/sweep.cu::
    owx_activity_chunk``), which travel by value in the launch: ints = L,
    C (0 without the TF cull), S, R, Ct, LUT texels (0 without the cull),
    the TF cull, the adaptive stride, then each slab's live bit; floats =
    the cell width of each level.  ``live``: (S,) bool on the host."""
    n_lv, s_, n_rt, n_ct = prep.acts_l.shape
    n_ch = 0 if prep.vmin is None else prep.vmin.shape[0]
    bits = (live if isinstance(live, torch.Tensor)
            else np.asarray(live)).reshape(-1).tolist()
    if len(bits) != s_:
        raise ValueError(f"live has {len(bits)} slabs, the tables {s_}")
    return (np.array([n_lv, n_ch, s_, n_rt, n_ct, n_texels if n_ch else 0,
                      n_ch > 0, adaptive_stride, *bits], np.int32),
            np.array(prep.cell_widths, np.float32))


def combine_activity_cuda(prep: ChunkPrep, live, luts, domains, *,
                          adaptive_stride: bool = False):
    """Launch K7 (``csrc/sweep.cu``) on the current stream: the tables of
    ``combine_activity_reference`` and the live mask as (S,) fp32 on the
    card, the form K1 reads.  ``live`` stays on the host (a tensor, array
    or sequence): its bits and the cell widths travel in the launch's
    arguments, so nothing is copied to the card.  Raises on any input the
    kernel does not take; never falls back."""
    from .. import kernels

    acts_l = prep.acts_l
    dev = acts_l.device
    if dev.type != "cuda":
        raise ValueError(f"combine_activity_cuda needs CUDA tables, got "
                         f"{dev}")
    if isinstance(live, torch.Tensor) and live.device.type != "cpu":
        raise ValueError(f"K7 takes live by value: pass it on the host, "
                         f"not on {live.device}")
    n_lv, s_, n_rt, n_ct = acts_l.shape
    kernels.check_levels("K7", n_lv)
    if not 1 <= s_ <= kernels.MAX_SLABS:
        raise ValueError(f"{s_} slabs; K7 takes 1..{kernels.MAX_SLABS}")
    kernels.check_tensor("acts_l", acts_l, dev, tuple(acts_l.shape),
                         torch.bool)
    cull, n_tex = [None, None, None], 0  # vmin, vmax, domains; then LUTs
    if prep.vmin is not None:
        n_ch = prep.vmin.shape[0]
        if not 1 <= n_ch <= MAX_CHANNELS or len(luts) < n_ch:
            raise ValueError(f"{n_ch} channels with {len(luts)} LUTs; K7 "
                             f"takes 1..{MAX_CHANNELS}")
        n_tex = luts[0].shape[0]
        if not 2 <= n_tex <= kernels.MAX_TEXELS:
            raise ValueError(f"{n_tex} LUT texels; K7 takes "
                             f"2..{kernels.MAX_TEXELS}")
        kernels.check_tensor("vmin", prep.vmin, dev, (n_ch, s_, n_rt))
        kernels.check_tensor("vmax", prep.vmax, dev, (n_ch, s_, n_rt))
        if not isinstance(domains, torch.Tensor) or len(domains) < n_ch:
            raise ValueError(f"domains: need a ({n_ch}, 2) tensor")
        kernels.check_tensor("domains", domains, dev, (len(domains), 2))
        for c in range(n_ch):
            kernels.check_tensor(f"luts[{c}]", luts[c], dev, (n_tex, 4))
        cull = [prep.vmin, prep.vmax, domains, *luts[:n_ch]]
    int_a, flt_a = _k7_packs(prep, live, n_tex, adaptive_stride)
    f32 = torch.float32
    act_f = torch.empty((s_, n_rt, n_ct), dtype=f32, device=dev)
    act_all_f = torch.empty((n_rt, n_ct), dtype=f32, device=dev)
    live_f = torch.empty(s_, dtype=f32, device=dev)
    ptrs = [acts_l, *cull[:3], act_f, act_all_f, live_f, *cull[3:]]
    ptr_a = np.array([0 if t is None else t.data_ptr() for t in ptrs],
                     np.uint64)
    # the packs' addresses as plain ints: the cheapest form ctypes takes
    kernels.launch("owx_activity_chunk", "K7",
                   ptr_a.ctypes.data, len(ptr_a), int_a.ctypes.data,
                   len(int_a), flt_a.ctypes.data, len(flt_a),
                   kernels.stream_arg(dev))
    profiling.count("launch.K7")
    return act_f, act_all_f, live_f


@profiling.in_span("activity")
def combine_activity(prep: ChunkPrep, live, luts, domains, *,
                     adaptive_stride: bool = False, plain: bool = False):
    """Per-frame activity tables of one chunk: K7 for CUDA tables, the
    plain-torch version for CPU tables (or anywhere when ``plain``).
    ``live``: the (S,) bool live mask, on the host for K7.  Returns
    (act_f (S, R, Ct), act_all_f (R, Ct), live_f (S,)) fp32 on the
    tables' device; K1 takes ``live_f``."""
    dev = prep.acts_l.device
    if not plain and dev.type == "cuda":
        return combine_activity_cuda(prep, live, luts, domains,
                                     adaptive_stride=adaptive_stride)
    if not (isinstance(live, torch.Tensor) and live.device == dev):
        with profiling.sync("sync.live", dev):
            live = torch.as_tensor(live, device=dev)
    act_f, act_all_f = combine_activity_reference(
        prep, live, luts, domains, adaptive_stride=adaptive_stride)
    return act_f, act_all_f, live.to(torch.float32)


class ClassifyTables(NamedTuple):
    """Frame-state classification tables (``pallas_sweep._pack_luts``).

    Compressed (``knots is not None``): f(u) = base + sum_j sd_j *
    relu(u - pos_j), positions sorted and padded with N; ``cum`` holds the
    prefix sums the two-sided knot window folds below a tile's min texel
    coordinate.  ``tau[c]``: channel c's 4th component is optical depth.
    Dense: the 128-texel LUT and its first differences."""

    domains: torch.Tensor  # (C, 2)
    n_texels: int
    compressed: bool
    tau: Tuple[bool, ...]
    kpos: Optional[torch.Tensor] = None  # (C, M)
    ksd: Optional[torch.Tensor] = None  # (C, M, 4)
    kbase: Optional[torch.Tensor] = None  # (C, 4)
    kcum: Optional[torch.Tensor] = None  # (C, M+1, 8)
    lut: Optional[torch.Tensor] = None  # (C, N, 4)
    dlut: Optional[torch.Tensor] = None  # (C, N, 4); [0] = lut[0]


def pack_luts(luts, domains, knots, device) -> ClassifyTables:
    """Classification tables for the sweep (``pallas_sweep._pack_luts``).
    luts: per channel (N, 4) alpha-prescaled tensors; domains: (C, 2)."""
    f32 = torch.float32
    dom = torch.as_tensor(domains, dtype=f32).to(device).reshape(-1, 2)
    n = int(luts[0].shape[0])
    if knots is not None:
        def t(a):
            with profiling.sync("sync.knots", device):
                return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        return ClassifyTables(
            domains=dom.contiguous(), n_texels=n, compressed=True,
            tau=tuple(bool(x) for x in knots.tau),
            kpos=t(knots.pos).contiguous(), ksd=t(knots.sd).contiguous(),
            kbase=t(knots.base).contiguous(),
            kcum=t(knots.cum).contiguous(),
        )
    lut = torch.stack([torch.as_tensor(l, dtype=f32).to(device)
                       for l in luts])
    dlut = torch.cat([lut[:, :1], lut[:, 1:] - lut[:, :-1]], dim=1)
    return ClassifyTables(
        domains=dom.contiguous(), n_texels=n, compressed=False,
        tau=(False,) * lut.shape[0], lut=lut.contiguous(),
        dlut=dlut.contiguous(),
    )


def _y_taps(yp: torch.Tensor, cw: float, org: float, ny: int):
    """Rows and tent weights of the two lattice rows a slab plane's
    y positions reach on one level.  q is measured from the row itself
    (``t - (org + 0.5 + k)``, the subtracted term exact), as the JAX
    kernel's tent build does, so the weights round alike; rows outside
    [0, ny) get zero weight."""
    t = yp / cw
    base = torch.tensor(np.float32(org) + np.float32(0.5), device=yp.device)
    k0f = torch.floor(t - base)
    q0 = t - (base + k0f)
    q1 = t - (base + (k0f + 1.0))
    k0 = k0f.to(torch.int64)
    k1 = k0 + 1
    w0 = torch.where((k0 >= 0) & (k0 < ny),
                     torch.clamp(1.0 - torch.abs(q0), min=0.0), 0.0)
    w1 = torch.where((k1 >= 0) & (k1 < ny),
                     torch.clamp(1.0 - torch.abs(q1), min=0.0), 0.0)
    return (torch.clamp(k0, 0, ny - 1), w0), (torch.clamp(k1, 0, ny - 1), w1)


def sweep_chunk_reference(prep: ChunkPrep, sec: torch.Tensor,
                          live: torch.Tensor, tables: ClassifyTables, dz,
                          height: int, width: int, *, act_f, act_all_f,
                          prev_trans=None, t_stop=None, tiles=(0, 0),
                          adaptive_stride: bool = False, done=None):
    """Plain-torch K1: the same function as ``csrc/sweep.cu``, vectorized
    over tiles instead of one thread block per tile.  Per tile the skip
    decisions (stride weight, saturation, field support) and the knot
    window are taken exactly as the kernel takes them.  ``t_stop``:
    optional (t_slab (S,), t_stop (H, W)), the surface stop: a sample
    counts only where t_slab[s] < t_stop at its pixel.  ``done``:
    optional (1,) bool, the early exit's flag: when set, every tile skips
    as one that earlier chunks saturated.  Returns (rgb (3, H, W), trans
    (H, W)) premultiplied, absolute transmittance.
    """
    f32 = torch.float32
    dev = sec.device
    h, w = height, width
    n_ch = len(prep.mids[0]) - 1
    s_ = prep.y_pos.shape[0]
    tr, tc = tile_shape(h, w, tiles, adaptive_stride)
    n_rt, n_ct = -(-h // tr), -(-w // tc)
    hp, wp = n_rt * tr, n_ct * tc
    has_pt = prev_trans is not None
    n = float(tables.n_texels)
    dz = torch.tensor(np.float32(dz), device=dev)

    def tiled(img, fill):
        """(H, W) -> (R, Ct, tr*tc), padded with ``fill``."""
        out = torch.full((hp, wp), fill, dtype=img.dtype, device=dev)
        out[:h, :w] = img
        return (out.reshape(n_rt, tr, n_ct, tc).permute(0, 2, 1, 3)
                .reshape(n_rt, n_ct, tr * tc))

    def untiled(t):
        return (t.reshape(n_rt, n_ct, tr, tc).permute(0, 2, 1, 3)
                .reshape(hp, wp)[:h, :w])

    inb = tiled(torch.ones((h, w), dtype=torch.bool, device=dev), False)
    sec_t = tiled(sec, 1.0)
    if has_pt:
        t_run = tiled(prev_trans.to(f32), 0.0)
    else:
        t_run = torch.ones((n_rt, n_ct, tr * tc), dtype=f32, device=dev)
    r_acc = torch.zeros_like(t_run)
    g_acc = torch.zeros_like(t_run)
    b_acc = torch.zeros_like(t_run)
    all_act = act_all_f > 0.5
    live_h = live.cpu()
    if t_stop is not None:
        t_slab = t_stop[0].to(device=dev, dtype=f32)
        t_stop_img = t_stop[1].to(f32)

    for s in range(s_):
        w_s = torch.where(all_act, 1.0, act_f[s])  # (R, Ct)
        do = (w_s > 0.0) & (t_run.amax(-1) > 0.005)
        if done is not None:
            # a set flag: every tile skips, as one earlier chunks saturated
            do = do & ~done
        if not bool(live_h[s]) or not bool(do.any()):
            continue
        # y-interpolation of every level's mids, levels in order
        sw = torch.zeros((h, w), dtype=f32, device=dev)
        swv = [torch.zeros((h, w), dtype=f32, device=dev)
               for _ in range(n_ch)]
        yp = prep.y_pos[s]
        for li, mids in enumerate(prep.mids):
            ny = mids.shape[2]
            taps = _y_taps(yp, prep.cell_widths[li], prep.origins_y[li], ny)
            for rows, wt in taps:
                block = mids[:, s].index_select(1, rows)  # (C+1, H, W)
                sw = sw + wt[:, None] * block[n_ch]
                for c in range(n_ch):
                    swv[c] = swv[c] + wt[:, None] * block[c]
        ok = sw > 1e-20
        if t_stop is not None:
            ok = ok & (t_slab[s] < t_stop_img)
        denom = torch.where(ok, sw, 1.0)
        ok_t = tiled(ok, False) & inb
        do = do & ok_t.any(-1)
        if not bool(do.any()):
            continue
        dzw = dz * w_s  # (R, Ct)
        expo = dzw[..., None] * sec_t
        slab_a = torch.zeros_like(t_run)
        slab_r = torch.zeros_like(t_run)
        slab_g = torch.zeros_like(t_run)
        slab_b = torch.zeros_like(t_run)
        for c in range(n_ch):
            value = swv[c] / denom
            lo = tables.domains[c, 0]
            hi = tables.domains[c, 1]
            sc = (n - 1.0) * (value - lo) / ((hi - lo) + 1e-20)
            sc = torch.clamp(sc + 0.5, 0.0, n - 1.0) / (n - 1.0)
            u_raw = tiled(torch.clamp(sc * n - 0.5, 0.0, n - 1.0), 0.0)
            u = torch.where(ok_t, u_raw, 0.0)
            u_min = torch.where(ok_t, u_raw, n - 1.0).amin(-1)  # (R, Ct)
            u_max = u.amax(-1)
            if tables.compressed:
                pos = tables.kpos[c]  # (M,)
                m_lo = (pos <= u_min[..., None]).sum(-1)  # (R, Ct)
                m_hi = (pos < u_max[..., None]).sum(-1)
                cum = tables.kcum[c][m_lo]  # (R, Ct, 8)
                acc = [(tables.kbase[c, k] + u * cum[..., k, None])
                       - cum[..., 4 + k, None] for k in range(4)]
                for j in range(pos.shape[0]):
                    inw = ((j >= m_lo) & (j < m_hi))[..., None]
                    ramp = torch.clamp(u - pos[j], min=0.0)
                    acc = [torch.where(inw, a + ramp * tables.ksd[c, j, k],
                                       a) for k, a in enumerate(acc)]
            else:
                k_lo = torch.clamp(torch.floor(u_min).to(torch.int64),
                                   0, int(n) - 2)
                k_hi = torch.clamp(torch.floor(u_max).to(torch.int64),
                                   0, int(n) - 2)
                base = tables.lut[c][k_lo]  # (R, Ct, 4)
                acc = [base[..., k, None].expand_as(u) for k in range(4)]
                for kk in range(int(n) - 1):
                    inw = ((kk >= k_lo) & (kk <= k_hi))[..., None]
                    ramp = torch.clamp(u - float(kk), 0.0, 1.0)
                    acc = [torch.where(inw,
                                       a + ramp * tables.dlut[c, kk + 1, k],
                                       a) for k, a in enumerate(acc)]
            cr, cg, cb, ca = acc
            if tables.compressed and tables.tau[c]:
                # optical depth: 1-(1-a)^e == 1-exp(-tau*e)
                ca = 1.0 - torch.exp(-torch.clamp(ca, min=0.0) * expo)
            else:
                ca = 1.0 - torch.pow(torch.clamp(1.0 - ca, min=0.0), expo)
            ca = torch.where(ok_t, ca, 0.0)
            contrib = (1.0 - slab_a) * ca
            slab_r = slab_r + contrib * cr
            slab_g = slab_g + contrib * cg
            slab_b = slab_b + contrib * cb
            slab_a = slab_a + contrib
        upd = do[..., None]
        r_acc = torch.where(upd, r_acc + t_run * slab_r, r_acc)
        g_acc = torch.where(upd, g_acc + t_run * slab_g, g_acc)
        b_acc = torch.where(upd, b_acc + t_run * slab_b, b_acc)
        t_run = torch.where(upd, t_run * (1.0 - slab_a), t_run)
    rgb = torch.stack([untiled(r_acc), untiled(g_acc), untiled(b_acc)])
    return rgb, untiled(t_run)


def _k1_ints(prep: ChunkPrep, tables: ClassifyTables, height: int,
             width: int, tiles, adaptive_stride: bool, has_pt: bool,
             has_stop: bool) -> np.ndarray:
    """K1's int argument pack (``csrc/sweep.cu::owx_sweep_chunk``)."""
    tr, tc = tile_shape(height, width, tiles, adaptive_stride)
    m_k = tables.kpos.shape[1] if tables.compressed else 0
    tau_mask = sum(1 << c for c, t in enumerate(tables.tau)
                   if t and tables.compressed)
    ints = [len(prep.mids), prep.mids[0].shape[0] - 1,
            prep.y_pos.shape[0], height, width, tr, tc,
            int(tables.compressed), tables.n_texels, m_k, tau_mask,
            int(has_pt), int(has_stop),
            *[int(m.shape[2]) for m in prep.mids]]
    return np.asarray(ints, np.int32)


K1_SHAPE_KEYS = ("cluster", "grid_x", "grid_y", "threads", "smem_bytes",
                 "carry_on_chip", "carry_floats", "rows_per_block",
                 "max_active_clusters")


def k1_launch_shape(prep: ChunkPrep, tables: ClassifyTables, height: int,
                    width: int, *, tiles=(0, 0),
                    adaptive_stride: bool = False, has_pt: bool = False,
                    has_stop: bool = False, occupancy: bool = False):
    """K1's launch for this chunk on the current card, as a dict of
    ``K1_SHAPE_KEYS``: blocks per tile (one cluster), the grid, threads
    per block, dynamic shared memory, whether the carry fits on chip (else
    the floats of its global scratch), rows per block and, with
    ``occupancy``, the most clusters the card runs at once."""
    return _k1_shape(_k1_ints(prep, tables, height, width, tiles,
                              adaptive_stride, has_pt, has_stop), occupancy)


def _k1_shape(int_a: np.ndarray, occupancy: bool = False):
    from .. import kernels

    out = np.zeros(len(K1_SHAPE_KEYS), np.int32)
    kernels.launch("owx_sweep_shape", "K1",
                   int_a.ctypes.data_as(ctypes.c_void_p), len(int_a),
                   int(occupancy), out.ctypes.data_as(ctypes.c_void_p))
    return dict(zip(K1_SHAPE_KEYS, out.tolist()))


def sweep_chunk_cuda(prep: ChunkPrep, sec: torch.Tensor,
                     live: torch.Tensor, tables: ClassifyTables, dz,
                     height: int, width: int, *, act_f, act_all_f,
                     prev_trans=None, t_stop=None, tiles=(0, 0),
                     adaptive_stride: bool = False, done=None):
    """Launch K1 (``csrc/sweep.cu``) on the current stream.  Same
    arguments and result as ``sweep_chunk_reference``.  Raises on any
    input the kernel does not take; never falls back."""
    from .. import kernels

    h, w = height, width
    dev = sec.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_chunk_cuda needs CUDA tensors, got {dev}")
    n_lv = len(prep.mids)
    n_ch = prep.mids[0].shape[0] - 1
    s_ = prep.y_pos.shape[0]
    kernels.check_levels("K1", n_lv)
    if not 1 <= n_ch <= MAX_CHANNELS:
        raise ValueError(f"{n_ch} channels; K1 takes 1..{MAX_CHANNELS}")
    tr, tc = tile_shape(h, w, tiles, adaptive_stride)
    n_rt, n_ct = -(-h // tr), -(-w // tc)

    def check(name, t, shape):
        kernels.check_tensor(name, t, dev, shape)

    for li, m in enumerate(prep.mids):
        check(f"mids[{li}]", m, (n_ch + 1, s_, m.shape[2], w))
    check("y_pos", prep.y_pos, (s_, h))
    check("sec", sec, (h, w))
    live_f = live.to(torch.float32).contiguous()
    check("live", live_f, (s_,))
    check("act_f", act_f, (s_, n_rt, n_ct))
    check("act_all_f", act_all_f, (n_rt, n_ct))
    if prev_trans is not None:
        check("prev_trans", prev_trans, (h, w))
    t_slab = t_stop_img = None
    if t_stop is not None:
        t_slab = t_stop[0].to(device=dev, dtype=torch.float32).contiguous()
        t_stop_img = t_stop[1]
        check("t_slab", t_slab, (s_,))
        check("t_stop", t_stop_img, (h, w))
    if done is not None:
        kernels.check_tensor("done", done, dev, (1,), torch.bool)
    check("domains", tables.domains, (n_ch, 2))
    if tables.compressed:
        m_k = tables.kpos.shape[1]
        check("kpos", tables.kpos, (n_ch, m_k))
        check("ksd", tables.ksd, (n_ch, m_k, 4))
        check("kbase", tables.kbase, (n_ch, 4))
        check("kcum", tables.kcum, (n_ch, m_k + 1, 8))
    else:
        check("lut", tables.lut, (n_ch, tables.n_texels, 4))
        check("dlut", tables.dlut, (n_ch, tables.n_texels, 4))

    int_a = _k1_ints(prep, tables, h, w, tiles, adaptive_stride,
                     prev_trans is not None, t_stop is not None)
    shape = _k1_shape(int_a)
    out = torch.empty((4, h, w), dtype=torch.float32, device=dev)
    # the carry's global scratch, for a tile whose carry does not fit in
    # shared memory (none at the main path's tiles)
    carry = (torch.empty(shape["carry_floats"], dtype=torch.float32,
                         device=dev) if shape["carry_floats"] else None)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = [prep.y_pos, sec, live_f, act_f, act_all_f, prev_trans,
            tables.domains, tables.kpos, tables.ksd, tables.kbase,
            tables.kcum, tables.lut, tables.dlut, carry,
            out[0], out[1], out[2], out[3], t_slab, t_stop_img, done,
            *prep.mids]
    flts = [np.float32(dz), *prep.cell_widths, *prep.origins_y]
    ptr_a = np.asarray([ptr(t) for t in ptrs], np.uint64)
    flt_a = np.asarray(flts, np.float32)
    kernels.launch("owx_sweep_chunk", "K1",
                   ptr_a.ctypes.data_as(ctypes.c_void_p), len(ptr_a),
                   int_a.ctypes.data_as(ctypes.c_void_p), len(int_a),
                   flt_a.ctypes.data_as(ctypes.c_void_p), len(flt_a),
                   kernels.stream_arg(dev))
    profiling.count("launch.K1")
    return out[:3], out[3]


@profiling.in_span("sweep")
def run_chunk(prep: ChunkPrep, sec, live, tables: ClassifyTables, dz,
              height: int, width: int, *, act_f, act_all_f,
              prev_trans=None, t_stop=None, tiles=(0, 0),
              adaptive_stride: bool = False, done=None,
              plain: bool = False):
    """Sweep one prepared chunk: K1 for CUDA tensors, the plain-torch
    version for CPU tensors (or anywhere when ``plain``, the explicit
    choice a kernel-vs-plain comparison makes).  ``t_stop``: optional
    (t_slab (S,), t_stop (H, W)), as in ``pallas_sweep.run_chunk``;
    ``done``: optional (1,) bool on the device, the early exit's flag
    (set: rgb 0 and ``prev_trans`` back, the slabs left unswept)."""
    fn = (sweep_chunk_reference if plain or sec.device.type == "cpu"
          else sweep_chunk_cuda)
    return fn(prep, sec, live, tables, dz, height, width, act_f=act_f,
              act_all_f=act_all_f, prev_trans=prev_trans, t_stop=t_stop,
              tiles=tiles, adaptive_stride=adaptive_stride, done=done)


def sweep_chunk(mids, origins_y, cell_widths, y_pos, sec, live, luts,
                domains, dz, height: int, width: int, *, knots=None,
                tf_cull=None, t_stop=None, tiles=(0, 0),
                adaptive_stride: bool = False, prev_trans=None,
                plain: bool = False):
    """Prepare + combine + run for one chunk (the uncached path), with
    ``pallas_sweep.sweep_chunk``'s argument order.  mids: per level
    (C+1, S, ny, W); luts: per channel (N, 4) alpha-prescaled tensors;
    domains: (C, 2); t_stop: optional (t_slab (S,), t_stop (H, W)).
    Returns (rgb (3, H, W), trans (H, W))."""
    prep = prepare_chunk(mids, origins_y, cell_widths, y_pos, height, width,
                         tiles=tiles, adaptive_stride=adaptive_stride,
                         tf_cull=tf_cull)
    act_f, act_all_f, live_f = combine_activity(
        prep, live, luts, domains, adaptive_stride=adaptive_stride,
        plain=plain)
    tables = pack_luts(luts, domains, knots, sec.device)
    return run_chunk(prep, sec, live_f, tables, dz, height, width,
                     act_f=act_f, act_all_f=act_all_f,
                     prev_trans=prev_trans, t_stop=t_stop, tiles=tiles,
                     adaptive_stride=adaptive_stride, plain=plain)

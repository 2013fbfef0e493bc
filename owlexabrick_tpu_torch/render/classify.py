"""Transfer-function classification (the port of
``owlexabrick_tpu/render/pallas_xf.py``): the einsum lane's two kernels
and the stand-alone LUT lookup.

* K3, ``composite_mids``: the one-channel clip route's chunk from each
  occupied level's mids (2, S, ny, W) and y taps: the y lerp summed over
  levels into sw, swv, the clip interval's masks, value = swv/sw,
  classification, opacity correction and the front-to-back composite
  over the chunk's live slabs, into premultiplied chunk rgb (3, H, W)
  and transmittance (H, W); no (S, H, W) field is built.
* K4, ``classify_field``: the classification and opacity per (slab,
  pixel) of the fields, no composite: r, g, b, a, each (S, H, W), a = 0
  where the sample is invalid.  The multi-channel and gradient-shading
  lanes.
* K5, ``xf_classify``: the LUT's r, g, b, a at clamped texel
  coordinates u (R, C).  The iso path's colormap recolor.

Each has a plain-torch version (``*_reference``), a launcher of the
hand-written Hopper kernel in ``csrc/xf.cu`` (``*_cuda``, counting its
launches in ``utils.profiling.counts``: ``launch.K3`` ... ``launch.K5``)
and a dispatcher: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise, and ``plain=True``
(``SlabConfig.plain_sweep``) is the one explicit way to run the plain
version on the card.  ``composite_chunk_reference``, K3's composite
over (S, H, W) fields, is the JAX package's ``composite_chunk`` in
torch; K3's plain version ends in it.

The TPU kernels walked the knots between a tile's least and greatest
texel coordinate (K5: all N-1 of them); for one pixel that walk
telescopes to a lerp of the LUT at k = min(floor(u), N-2), which both
versions here evaluate (they differ from the walk only in rounding).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import profiling


def _domain(domain):
    """(lo, hi) of a channel's TF domain (2,) as float32 host scalars."""
    lo, hi = np.asarray(domain, np.float32).reshape(2)
    return np.float32(lo), np.float32(hi)


def texel_coord(value: torch.Tensor, lo, hi, n: int) -> torch.Tensor:
    """value -> clamped texel coordinate in [0, n-1] (``xf_texel_coord``,
    exabrick.cu:136-150), in the kernels' float32 operation order."""
    dev = value.device
    lo_t, hi_t, nm1 = (torch.tensor(np.float32(v), device=dev)
                       for v in (lo, hi, n - 1))
    s = nm1 * (value - lo_t) / ((hi_t - lo_t) + 1e-20)
    # divide by a device tensor: torch turns a CUDA tensor's division by
    # a host scalar into a multiply by its reciprocal, which rounds
    # otherwise than the kernels' division
    s = torch.clamp(s + 0.5, 0.0, n - 1.0) / nm1
    return torch.clamp(s * float(n) - 0.5, 0.0, n - 1.0)


def _classify(value: torch.Tensor, lut: torch.Tensor, lo, hi):
    """Per-sample rgba: the LUT lerped at the texel coordinate of
    ``value``, one component at a time (lut[k] + f * (lut[k+1] - lut[k]),
    k = min(floor(u), N-2))."""
    n = int(lut.shape[0])
    u = texel_coord(value, lo, hi, n)
    k = torch.clamp(torch.floor(u).to(torch.int64), max=n - 2)
    f = u - k.to(torch.float32)
    out = []
    for c in range(4):
        col = lut[:, c]
        out.append(col[k] + f * (col[1:] - col[:-1])[k])
    return out


def _opacity(a: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    """Opacity correction for the slab's path length: 1-(1-a)^(dz*sec)
    (exabrick.cu:1011), the base clamped at 0 first."""
    return 1.0 - torch.pow(torch.clamp(1.0 - a, min=0.0), expo)


def classify_field_reference(sw, swv, sec, lut, domain, dz):
    """Plain-torch K4: the same arithmetic as ``csrc/xf.cu``'s
    classify_field_kernel.  sw, swv: (S, H, W); sec: (H, W); lut: (N, 4)
    alpha-prescaled; domain: (2,); dz: the slab thickness.  Returns
    (r, g, b, a), each (S, H, W); a is opacity-corrected and 0 where the
    sample is invalid (sw <= 1e-20).  Every sample is classified, the
    invalid ones at value = swv, so no inf or NaN enters."""
    lo, hi = _domain(domain)
    ok = sw > 1e-20
    value = swv / torch.where(ok, sw, 1.0)
    r, g, b, a = _classify(value, lut, lo, hi)
    expo = torch.tensor(np.float32(dz), device=sw.device) * sec
    a = torch.where(ok, _opacity(a, expo), 0.0)
    return r, g, b, a


def composite_chunk_reference(sw, swv, sec, live, lut, domain, dz):
    """The classification, the ``live`` gate and the front-to-back
    composite of a chunk's fields, one slab at a time, in the float32
    operation order of ``csrc/xf.cu``'s K3.  sw, swv: (S, H, W);
    sec: (H, W); live: (S,) bool or 0/1; lut, domain, dz as in
    ``classify_field_reference``.  Returns (rgb (3, H, W) premultiplied
    chunk color, trans (H, W) chunk transmittance); merge into the frame
    with color += (1-alpha) rgb, alpha = 1 - (1-alpha) trans."""
    lo, hi = _domain(domain)
    dev = sw.device
    expo = torch.tensor(np.float32(dz), device=dev) * sec
    live_h = live.detach().cpu().to(torch.float32)
    r_acc = torch.zeros_like(sec)
    g_acc = torch.zeros_like(sec)
    b_acc = torch.zeros_like(sec)
    t_run = torch.ones_like(sec)
    for s in range(sw.shape[0]):
        # a dead slab adds exactly nothing (a = 0)
        if not live_h[s] > 0.0:
            continue
        valid = sw[s] > 1e-20
        value = swv[s] / torch.where(valid, sw[s], 1.0)
        r, g, b, a = _classify(value, lut, lo, hi)
        a = torch.where(valid, _opacity(a, expo), 0.0)
        contrib = t_run * a
        r_acc = r_acc + contrib * r
        g_acc = g_acc + contrib * g
        b_acc = b_acc + contrib * b
        t_run = t_run * (1.0 - a)
    return torch.stack([r_acc, g_acc, b_acc]), t_run


def mids_fields_reference(mids, ytaps, scale, t_start, t_stop, height,
                          width):
    """The y stage and the clip masks of K3 in plain torch: per level, in
    level order, ``acc = acc + (w0 * mid[r0] + w1 * mid[r1])`` at every
    screen row (``_lerp_y``'s form), then sw = 0 unless scale < t_stop,
    then unless scale >= t_start (``_EinsumLane.chunk``'s order).
    mids: per level (2, S, ny, W), the value channel then the mask;
    ytaps: per level (S, H, 4), (w0, w1, r0, r1) as ``tent_taps`` gives
    them (rows stored as floats); scale: (S,); t_start / t_stop: (H, W)
    or None.  Returns (sw, swv), each (S, H, W)."""
    s_ = scale.shape[0]
    shape = (s_, height, width)
    sw = torch.zeros(shape, dtype=torch.float32, device=scale.device)
    swv = torch.zeros_like(sw)
    for mid, tp in zip(mids, ytaps):
        rows = [tp[..., 2 + t].to(torch.int64)[:, :, None].expand(shape)
                for t in (0, 1)]

        def lerp(m):
            return (tp[..., 0][:, :, None] * torch.gather(m, 1, rows[0])
                    + tp[..., 1][:, :, None] * torch.gather(m, 1, rows[1]))

        swv = swv + lerp(mid[0])
        sw = sw + lerp(mid[1])
    sc = scale[:, None, None]
    if t_stop is not None:
        sw = torch.where(sc < t_stop[None], sw, 0.0)
    if t_start is not None:
        sw = torch.where(sc >= t_start[None], sw, 0.0)
    return sw, swv


def composite_mids_reference(mids, ytaps, scale, t_start, t_stop, sec, lut,
                             domain, dz):
    """Plain-torch K3: the same inputs and arithmetic as ``csrc/xf.cu``'s
    composite_mids_kernel.  ``mids_fields_reference`` (the y stage and
    the clip masks), then ``composite_chunk_reference`` over the S
    slabs, every one live (the caller passes the chunk's live slabs
    only).  sec: (H, W); lut, domain, dz as in
    ``classify_field_reference``.  Returns (rgb (3, H, W), trans (H, W))
    as ``composite_chunk_reference``."""
    h, w = sec.shape
    sw, swv = mids_fields_reference(mids, ytaps, scale, t_start, t_stop, h,
                                    w)
    live = torch.ones(scale.shape[0], dtype=torch.bool)
    return composite_chunk_reference(sw, swv, sec, live, lut, domain, dz)


def composite_mids_cuda(mids, ytaps, scale, t_start, t_stop, sec, lut,
                        domain, dz):
    """Launch K3 (``csrc/xf.cu``) on the current stream: one launch for
    up to ``kernels.MAX_LEVELS`` levels (none gives a transparent chunk).
    Same arguments and result as ``composite_mids_reference``.  Raises on
    any input the kernel does not take; never falls back."""
    from .. import kernels

    dev = sec.device
    if dev.type != "cuda":
        raise ValueError(f"composite_mids_cuda needs CUDA tensors, got {dev}")
    if sec.dim() != 2 or scale.dim() != 1 or len(mids) != len(ytaps):
        raise ValueError(f"need sec (H, W), scale (S,) and one taps table "
                         f"per level, got {tuple(sec.shape)}, "
                         f"{tuple(scale.shape)}, {len(mids)} / {len(ytaps)}")
    h, w = sec.shape
    s_ = scale.shape[0]
    n = int(lut.shape[0])
    if not 1 <= s_ <= kernels.MAX_SLABS:
        raise ValueError(f"{s_} slabs; K3 takes 1..{kernels.MAX_SLABS}")
    kernels.check_levels("K3", len(mids), least=0)
    if not 2 <= n <= kernels.MAX_TEXELS:
        raise ValueError(f"{n} LUT texels; K3 takes 2..{kernels.MAX_TEXELS}")
    for m, tp in zip(mids, ytaps):
        kernels.check_tensor("mids", m, dev, (2, s_, m.shape[2], w))
        kernels.check_tensor("ytaps", tp, dev, (s_, h, 4))
    kernels.check_tensor("scale", scale, dev, (s_,))
    for name, t in (("t_start", t_start), ("t_stop", t_stop)):
        if t is not None:
            kernels.check_tensor(name, t, dev, (h, w))
    kernels.check_tensor("sec", sec, dev, (h, w))
    kernels.check_tensor("lut", lut, dev, (n, 4))
    lo, hi = _domain(domain)
    out = torch.empty((4, h, w), dtype=torch.float32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    nl = len(mids)

    def ptr(t):
        return vp(None if t is None else t.data_ptr())

    kernels.launch("owx_composite_mids", "K3",
                   (vp * nl)(*[m.data_ptr() for m in mids]),
                   (vp * nl)(*[tp.data_ptr() for tp in ytaps]),
                   (ci * nl)(*[m.shape[2] for m in mids]), nl, ptr(scale),
                   ptr(t_start), ptr(t_stop), ptr(sec), ptr(lut), ptr(out),
                   s_, h, w, n, cf(lo), cf(hi), cf(np.float32(dz)),
                   kernels.stream_arg(dev))
    profiling.count("launch.K3")
    return out[:3], out[3]


def composite_mids(mids, ytaps, scale, t_start, t_stop, sec, lut, domain,
                   dz, plain: bool = False):
    """K3 for CUDA tensors, the plain version for CPU tensors (or
    anywhere when ``plain``, the explicit choice a kernel-vs-plain
    comparison makes)."""
    fn = (composite_mids_reference if plain or sec.device.type == "cpu"
          else composite_mids_cuda)
    return fn(mids, ytaps, scale, t_start, t_stop, sec, lut, domain, dz)


def classify_field_cuda(sw, swv, sec, lut, domain, dz):
    """Launch K4 (``csrc/xf.cu``) on the current stream.  Same arguments
    and result as ``classify_field_reference``.  Raises on any input the
    kernel does not take; never falls back."""
    from .. import kernels

    dev = sw.device
    if dev.type != "cuda":
        raise ValueError(f"classify_field_cuda needs CUDA tensors, got {dev}")
    if sw.dim() != 3:
        raise ValueError(f"sw: need (S, H, W), got {tuple(sw.shape)}")
    s_, h, w = sw.shape
    n = int(lut.shape[0])
    if not 2 <= n <= kernels.MAX_TEXELS:
        raise ValueError(f"{n} LUT texels; K4 takes 2..{kernels.MAX_TEXELS}")
    kernels.check_tensor("sw", sw, dev, (s_, h, w))
    kernels.check_tensor("swv", swv, dev, (s_, h, w))
    kernels.check_tensor("sec", sec, dev, (h, w))
    kernels.check_tensor("lut", lut, dev, (n, 4))
    if s_ > 65535:
        raise ValueError(f"{s_} slabs; K4 takes at most 65535")
    lo, hi = _domain(domain)
    out = torch.empty((4, s_, h, w), dtype=torch.float32, device=sw.device)
    vp, cf = ctypes.c_void_p, ctypes.c_float
    kernels.launch("owx_classify_field", "K4", vp(sw.data_ptr()),
                   vp(swv.data_ptr()), vp(sec.data_ptr()),
                   vp(lut.data_ptr()), vp(out.data_ptr()), s_, h, w, n,
                   cf(lo), cf(hi), cf(np.float32(dz)),
                   kernels.stream_arg(sw.device))
    profiling.count("launch.K4")
    return out[0], out[1], out[2], out[3]


def classify_field(sw, swv, sec, lut, domain, dz, plain: bool = False):
    """K4 for CUDA tensors, the plain version for CPU tensors (or
    anywhere when ``plain``, the explicit choice a kernel-vs-plain
    comparison makes)."""
    fn = (classify_field_reference if plain or sw.device.type == "cpu"
          else classify_field_cuda)
    return fn(sw, swv, sec, lut, domain, dz)


def xf_classify_reference(u: torch.Tensor, lut: torch.Tensor):
    """Plain-torch K5: the same arithmetic as ``csrc/xf.cu``'s
    xf_classify_kernel.  u: (R, C) clamped texel coordinates in
    [0, N-1]; lut: (N, 4).  Returns (r, g, b, a), each (R, C): the LUT
    lerped at u, lut[k] + f * (lut[k+1] - lut[k]) with k = min(floor(u),
    N-2), f = u - k (the TPU kernel's sum of N-1 clamp ramps telescopes
    to this lerp, up to rounding)."""
    n = int(lut.shape[0])
    k = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
    f = u - k.to(torch.float32)
    out = []
    for c in range(4):
        col = lut[:, c]
        out.append(col[k] + f * (col[1:] - col[:-1])[k])
    return tuple(out)


def xf_classify_cuda(u: torch.Tensor, lut: torch.Tensor):
    """Launch K5 (``csrc/xf.cu``) on the current stream.  Same arguments
    and result as ``xf_classify_reference``.  Raises on any input the
    kernel does not take; never falls back."""
    from .. import kernels

    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"xf_classify_cuda needs CUDA tensors, got {dev}")
    if u.dim() != 2:
        raise ValueError(f"u: need (R, C), got {tuple(u.shape)}")
    n = int(lut.shape[0])
    if not 2 <= n <= kernels.MAX_TEXELS:
        raise ValueError(f"{n} LUT texels; K5 takes 2..{kernels.MAX_TEXELS}")
    kernels.check_tensor("u", u, dev, tuple(u.shape))
    kernels.check_tensor("lut", lut, dev, (n, 4))
    out = torch.empty((4,) + tuple(u.shape), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    kernels.launch("owx_xf_classify", "K5", vp(u.data_ptr()),
                   vp(lut.data_ptr()), vp(out.data_ptr()), u.numel(), n,
                   kernels.stream_arg(dev))
    profiling.count("launch.K5")
    return out[0], out[1], out[2], out[3]


def xf_classify(u: torch.Tensor, lut: torch.Tensor, plain: bool = False):
    """K5 for CUDA tensors, the plain version for CPU tensors (or
    anywhere when ``plain``): the (N, 4) LUT at texel coordinates u
    (R, C), as (r, g, b, a) (``pallas_xf.xf_classify``)."""
    fn = (xf_classify_reference if plain or u.device.type == "cpu"
          else xf_classify_cuda)
    return fn(u, lut)

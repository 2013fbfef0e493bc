"""Two-pass homography warp of shear-warp (the port of
``owlexabrick_tpu/render/pallas_warp.py``).

The final step of shear-warp resamples the intermediate lattice image at
projectively mapped screen positions, as two 1-D Catmull-Rom passes (the
two-pass transform of Catmull & Smith):

  pass 1 (K2a): V[v, a] = I[j(v, a), a] — for each screen row v and
    lattice column a, Catmull-Rom along the column; j(v, a) inverts the
    screen->lattice homography's i-equation for u at fixed (v, a).
  pass 2 (K2b): out[v, u] = V[v, i(u, v)] — Catmull-Rom along row v of V;
    rgb clamped at >= 0, channel 3 to [0, 1].

This filter is not the tensor-product bicubic wherever the map is not a
translation, so the port keeps it and keeps the reference's window
clamps, which change the image: each (8, 128) tile of the reference read
a window of bj lattice rows (pass 1) or bi columns (pass 2) starting at a
per-tile start computed from the tile's corners, and clipped its
coordinate to [1, b - 2] inside that window.  ``window_starts`` computes
the same starts in float32; the reference's window sum over b taps
equals the 4-tap form here because Catmull-Rom vanishes at distance >= 2.

For CUDA tensors ``warp_two_pass`` launches K2a / K2b, the kernels in
``csrc/warp.cu`` (``warp_pass1_cuda`` / ``warp_pass2_cuda``); for CPU
tensors (or ``plain=True``) it runs ``warp_pass1_reference`` /
``warp_pass2_reference``, the same functions in plain torch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import profiling

_TR = 8
_TC = 128


def _catmull_rom(d):
    """Catmull-Rom kernel value at distance ``d`` >= 0 (support < 2)."""
    d2 = d * d
    d3 = d2 * d
    near = 1.5 * d3 - 2.5 * d2 + 1.0
    far = -0.5 * d3 + 2.5 * d2 - 4.0 * d + 2.0
    return torch.where(d <= 1.0, near,
                       torch.where(d < 2.0, far, torch.zeros_like(d)))


def _safe_div(n, d):
    mag = torch.clamp(torch.abs(d), min=1e-20)
    return n / torch.where(d < 0, -mag, mag)


def _j_of_va(h, vc, a_shifted, shift_j):
    """j(v, a): invert the i-equation for u at fixed (vc, a), then apply
    the j-equation.  ``h`` is the flat (16,) float32 parameter vector
    (hom (2, 2, 3) in h[0:12], then jx, jy, shift_i, shift_j)."""
    uc = _safe_div(
        a_shifted * (h[4] * vc + h[5]) - h[1] * vc - h[2],
        h[0] - a_shifted * h[3],
    )
    return _safe_div(
        h[6] * uc + h[7] * vc + h[8],
        h[9] * uc + h[10] * vc + h[11],
    ) - shift_j


def _hom_eval(sw, uu, vv):
    hom = np.asarray(sw.hom, np.float64)
    w2, h2 = sw.screen[0] / 2.0, sw.screen[1] / 2.0
    uc, vc = uu - w2, vv - h2
    i = (hom[0, 0, 0] * uc + hom[0, 0, 1] * vc + hom[0, 0, 2]) / (
        hom[0, 1, 0] * uc + hom[0, 1, 1] * vc + hom[0, 1, 2]
    )
    j = (hom[1, 0, 0] * uc + hom[1, 0, 1] * vc + hom[1, 0, 2]) / (
        hom[1, 1, 0] * uc + hom[1, 1, 1] * vc + hom[1, 1, 2]
    )
    return i, j


def warp_windows(sw, width: int, height: int,
                 bi_buckets=(256, 384, 512),
                 bj_buckets=(32, 64, 128, 224)):
    """Window sizing from the map's derivative bounds (host numpy, the
    reference's buckets).  Returns (bi, bj) — pass-2 column window and
    pass-1 row window — or None when no bucket covers the warp (the
    caller falls back to the bicubic gather)."""
    iw, ih = sw.width, sw.height
    uu, vv = np.meshgrid(
        np.linspace(0.0, width, 33), np.linspace(0.0, height, 33)
    )
    i, j = _hom_eval(sw, uu, vv)
    su = width / 32.0
    sv = height / 32.0
    didu = np.abs(np.diff(i, axis=1)).max() / su
    didv = np.abs(np.diff(i, axis=0)).max() / sv
    # pass-1 j-variation per lattice column: dj/da = (dj/du)/(di/du)
    dj_du = np.diff(j, axis=1) / su
    di_du = np.diff(i, axis=1) / su
    djda = np.abs(dj_du / np.where(np.abs(di_du) < 1e-12, 1e-12, di_du))
    djda = djda.max()
    djdv = np.abs(np.diff(j, axis=0)).max() / sv
    # span over one tile + bicubic support + jitter + start quantization
    need_i = didu * _TC + didv * _TR + 6 + 128
    need_j = djda * _TC + djdv * _TR + 6 + 8
    bi = next((b for b in bi_buckets if need_i <= b <= iw), None)
    bj = next((b for b in bj_buckets if need_j <= b <= ih), None)
    if bi is None or bj is None:
        return None
    return bi, bj


def warp_params(sw, jx, jy, shift_i, shift_j) -> torch.Tensor:
    """The (16,) float32 parameter vector on the CPU: hom, jx, jy,
    shift_i, shift_j."""
    return torch.from_numpy(np.concatenate([
        np.asarray(sw.hom, np.float32).reshape(12),
        np.asarray([jx, jy, shift_i, shift_j], np.float32)]))


def window_starts(params: torch.Tensor, sw, width: int, height: int,
                  bi: int, bj: int):
    """Per-tile window starts (float32, on the CPU, as the reference's
    ``starts``): wj0 (n_vt, n_at) lattice rows for pass 1 from j at the
    corners of (8, 128) tiles of (v, a), quantized to 8; wi0 (n_vt, n_ut)
    lattice columns for pass 2 from i at the corners of (8, 128) tiles of
    (v, u), quantized to 128.  int32."""
    f32 = torch.float32
    iw, ih = sw.width, sw.height
    h = params
    n_vt = -(-height // _TR)
    n_at = -(-iw // _TC)
    n_ut = -(-width // _TC)

    def starts(c, n_src, b, quant):
        lo = torch.minimum(
            torch.minimum(c[:-1, :-1], c[:-1, 1:]),
            torch.minimum(c[1:, :-1], c[1:, 1:]),
        )
        s = torch.floor(torch.clamp(lo, 0.0, n_src - 1.0)).to(
            torch.int32) - 2
        s = torch.div(s, quant, rounding_mode="floor") * quant
        return torch.clamp(s, 0, n_src - b).to(torch.int32).contiguous()

    cv = (torch.arange(n_vt + 1, dtype=f32)[:, None] * _TR
          + (h[13] - height / 2.0))
    ca = torch.arange(n_at + 1, dtype=f32)[None, :] * _TC + h[14]
    wj0 = starts(_j_of_va(h, cv, ca, h[15]), ih, bj, 8)
    cu = torch.arange(n_ut + 1, dtype=f32)[None, :] * _TC + (
        h[12] - width / 2.0)
    ci = (h[0] * cu + h[1] * cv + h[2]) / (h[3] * cu + h[4] * cv + h[5]) \
        - h[14]
    wi0 = starts(ci, iw, bi, 128)
    return wj0, wi0


def _taps(x, n_win):
    """The four Catmull-Rom taps of window coordinates ``x`` (already
    clipped to [1, n_win - 2]): local indices floor(x)-1 .. floor(x)+2
    and their weights (0 for the one index past the window's end, where
    the reference's window holds no sample)."""
    k0 = torch.floor(x)
    out = []
    for t in (-1.0, 0.0, 1.0, 2.0):
        k = k0 + t
        w = torch.where(k <= n_win - 1.0, _catmull_rom(torch.abs(x - k)),
                        torch.zeros_like(x))
        out.append((k.to(torch.int64), w))
    return out


def _check_window(sw, b: int, n_src: int):
    """The lattice shapes a pass takes: whole 128-column tiles, and a
    window of ``b`` rows or columns inside the ``n_src`` the pass reads."""
    if sw.width % _TC:
        raise ValueError(f"lattice width {sw.width} is not a multiple of "
                         f"{_TC}; warp_windows admits no two-pass warp")
    if not 4 <= b <= n_src:
        raise ValueError(f"window {b} outside [4, {n_src}]")


def warp_pass1_reference(rgba_i, wj0, params, sw, height: int, bj: int):
    """Pass 1 (plain torch): V (C, h_pad, iw) from the intermediate image
    rgba_i (ih*iw, C), h_pad = ceil(height / 8) * 8."""
    _check_window(sw, bj, sw.height)
    f32 = torch.float32
    dev = rgba_i.device
    iw, ih = sw.width, sw.height
    c = rgba_i.shape[1]
    h = params.to(dev)
    h_pad = -(-height // _TR) * _TR
    img = rgba_i.T.reshape(c, ih * iw)
    vv = torch.arange(h_pad, device=dev)
    aa = torch.arange(iw, device=dev)
    vc = vv.to(f32)[:, None] + (h[13] - height / 2.0)
    a = aa.to(f32)[None, :] + h[14]
    j0w = wj0.to(dev).to(torch.int64)[vv // _TR][:, aa // _TC]  # (h_pad, iw)
    j = _j_of_va(h, vc, a, h[15])
    j = torch.clamp(j, 1.0, ih - 2.0 - 1e-4) - j0w.to(f32)
    j = torch.clamp(j, 1.0, bj - 2.0)
    out = None
    for k, w in _taps(j, bj):
        rows = torch.clamp(j0w + k, 0, ih - 1)
        term = w[None] * img[:, rows * iw + aa[None, :]]
        out = term if out is None else out + term
    return out.contiguous()


def warp_pass2_reference(v_img, wi0, params, sw, width: int, height: int,
                         bi: int):
    """Pass 2 (plain torch): the screen image (width*height, C) from V
    (C, h_pad, iw); rgb clamped at >= 0, channel 3 to [0, 1]."""
    _check_window(sw, bi, sw.width)
    f32 = torch.float32
    dev = v_img.device
    iw = sw.width
    c, h_pad, _ = v_img.shape
    h = params.to(dev)
    vv = torch.arange(height, device=dev)
    uu = torch.arange(width, device=dev)
    u = uu.to(f32)[None, :] + (h[12] - width / 2.0)
    v = vv.to(f32)[:, None] + (h[13] - height / 2.0)
    i0w = wi0.to(dev).to(torch.int64)[vv // _TR][:, uu // _TC]  # (H, W)
    i = _safe_div(h[0] * u + h[1] * v + h[2],
                  h[3] * u + h[4] * v + h[5]) - h[14]
    i = torch.clamp(i, 1.0, iw - 2.0 - 1e-4) - i0w.to(f32)
    i = torch.clamp(i, 1.0, bi - 2.0)
    flat = v_img.reshape(c, h_pad * iw)
    out = None
    for k, w in _taps(i, bi):
        cols = torch.clamp(i0w + k, 0, iw - 1)
        term = w[None] * flat[:, vv[:, None] * iw + cols]
        out = term if out is None else out + term
    if c == 4:
        out = torch.cat([torch.clamp(out[:3], min=0.0),
                         torch.clamp(out[3:4], 0.0, 1.0)])
    else:
        out = torch.clamp(out, min=0.0)
    return out.reshape(c, height * width).T


def warp_pass1_cuda(rgba_i, wj0, params, sw, height: int, bj: int):
    """Launch K2a (``csrc/warp.cu``) on the current stream.  Same
    arguments and result as ``warp_pass1_reference``; raises on any input
    the kernel does not take, never falls back."""
    from .. import kernels

    dev = rgba_i.device
    if dev.type != "cuda":
        raise ValueError(f"warp_pass1_cuda needs CUDA tensors, got {dev}")
    _check_window(sw, bj, sw.height)
    iw, ih = sw.width, sw.height
    c = rgba_i.shape[1]
    if not 1 <= c <= kernels.MAX_COLOR_COMPONENTS:
        raise ValueError(f"{c} channels; K2 takes "
                         f"1..{kernels.MAX_COLOR_COMPONENTS}")
    n_vt, n_at = -(-height // _TR), iw // _TC
    if (rgba_i.device != dev or rgba_i.dtype != torch.float32
            or tuple(rgba_i.shape) != (ih * iw, c)):
        raise ValueError(f"rgba_i: need float32 ({ih * iw}, {c}) on {dev}, "
                         f"got {rgba_i.dtype} {tuple(rgba_i.shape)}")
    kernels.check_tensor("wj0", wj0, dev, (n_vt, n_at), torch.int32)
    hp = np.ascontiguousarray(params.cpu().numpy(), np.float32)
    out = torch.empty((c, n_vt * _TR, iw), dtype=torch.float32, device=dev)
    # any strides: the sweep's rgba is a transposed (C, P) image, the
    # Renderer's composited color whatever layout the composite kept
    kernels.launch("owx_warp_pass1", "K2a",
                   ctypes.c_void_p(rgba_i.data_ptr()), rgba_i.stride(0),
                   rgba_i.stride(1), ctypes.c_void_p(wj0.data_ptr()),
                   ctypes.c_void_p(out.data_ptr()),
                   hp.ctypes.data_as(ctypes.c_void_p), c, iw, ih, height, bj,
                   kernels.stream_arg(dev))
    profiling.count("launch.K2a")
    return out


def warp_pass2_cuda(v_img, wi0, params, sw, width: int, height: int,
                    bi: int):
    """Launch K2b (``csrc/warp.cu``) on the current stream.  Same
    arguments and result as ``warp_pass2_reference``; raises on any input
    the kernel does not take, never falls back."""
    from .. import kernels

    dev = v_img.device
    if dev.type != "cuda":
        raise ValueError(f"warp_pass2_cuda needs CUDA tensors, got {dev}")
    _check_window(sw, bi, sw.width)
    iw = sw.width
    c = v_img.shape[0]
    if not 1 <= c <= kernels.MAX_COLOR_COMPONENTS:
        raise ValueError(f"{c} channels; K2 takes "
                         f"1..{kernels.MAX_COLOR_COMPONENTS}")
    n_vt, n_ut = -(-height // _TR), -(-width // _TC)
    kernels.check_tensor("v_img", v_img, dev, (c, n_vt * _TR, iw))
    kernels.check_tensor("wi0", wi0, dev, (n_vt, n_ut), torch.int32)
    hp = np.ascontiguousarray(params.cpu().numpy(), np.float32)
    out = torch.empty((height * width, c), dtype=torch.float32, device=dev)
    kernels.launch("owx_warp_pass2", "K2b",
                   ctypes.c_void_p(v_img.data_ptr()),
                   ctypes.c_void_p(wi0.data_ptr()),
                   ctypes.c_void_p(out.data_ptr()),
                   hp.ctypes.data_as(ctypes.c_void_p), c, iw, width, height,
                   bi, kernels.stream_arg(dev))
    profiling.count("launch.K2b")
    return out


def warp_two_pass_reference(rgba_i, sw, width: int, height: int, bi: int,
                            bj: int, jx=0.5, jy=0.5, shift_i=0.0,
                            shift_j=0.0):
    """K2a + K2b in plain torch.  rgba_i: (iw*ih, C) from the sweep.
    Returns (width*height, C)."""
    params = warp_params(sw, jx, jy, shift_i, shift_j)
    wj0, wi0 = window_starts(params, sw, width, height, bi, bj)
    v_img = warp_pass1_reference(rgba_i, wj0, params, sw, height, bj)
    return warp_pass2_reference(v_img, wi0, params, sw, width, height, bi)


def warp_two_pass_cuda(rgba_i, sw, width: int, height: int, bi: int,
                       bj: int, jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0):
    """K2a + K2b on the card; same arguments and result as
    ``warp_two_pass_reference``."""
    dev = rgba_i.device
    params = warp_params(sw, jx, jy, shift_i, shift_j)
    wj0, wi0 = window_starts(params, sw, width, height, bi, bj)
    with profiling.sync("sync.warp_windows", dev, 2):
        wj0, wi0 = wj0.to(dev), wi0.to(dev)
    v_img = warp_pass1_cuda(rgba_i, wj0, params, sw, height, bj)
    return warp_pass2_cuda(v_img, wi0, params, sw, width, height, bi)


def warp_two_pass(rgba_i, sw, width: int, height: int, bi: int, bj: int,
                  jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0,
                  plain: bool = False):
    """The two-pass warp: K2a + K2b for CUDA tensors, the plain-torch
    version for CPU tensors (or anywhere when ``plain``, the explicit
    choice a kernel-vs-plain comparison makes)."""
    fn = (warp_two_pass_reference if plain or rgba_i.device.type == "cpu"
          else warp_two_pass_cuda)
    return fn(rgba_i, sw, width, height, bi, bj, jx=jx, jy=jy,
              shift_i=shift_i, shift_j=shift_j)

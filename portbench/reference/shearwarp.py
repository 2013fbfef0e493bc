"""Shear-warp: the factorization of a tilted camera into an aligned
lattice camera and a screen warp, and the two-pass Catmull-Rom warp
(frozen copies of the port's ``render/shearwarp.py`` and the plain twins
of K2a / K2b in ``render/warp.py``), host float64 numpy and plain
torch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .camera import Camera, permute_camera


_PAD = 3  # lattice cells of margin for jitter + bicubic support


@dataclass(frozen=True)
class ShearWarp:
    """Per-(camera, screen-size) shear-warp factorization."""

    camera: Camera  # intermediate camera (voxel frame): pos + sweep sign
    width: int  # intermediate lattice dims (static per screen size)
    height: int
    # screen->lattice projective map: hom[k] = (num_row, den_row) over
    # centered screen coords (u - W/2, v - H/2, 1), k = 0 for i, 1 for j
    hom: np.ndarray  # (2, 2, 3) float64
    axis: int
    sign: float  # sweep direction (sign of rz)
    # lattice generators: u(i) = u_lo + (i + phase) * u_step;
    # xi_i = (a + b u)/(c + d u) with (a, b, c, d) = coef_u
    u_lo: float
    u_step: float
    coef_u: Tuple[float, float, float, float]
    v_lo: float
    v_step: float
    coef_v: Tuple[float, float, float, float]
    screen: Tuple[int, int]  # (width, height) of the screen

    def lattice(self, kx: float = 0.0, ky: float = 0.0):
        """Lateral ray components ((iw,), (ih,)) float32 for the sweep,
        with an optional sub-cell phase shift (kx, ky) for jittered
        accumulation (compensated in the warp via shift_i/shift_j)."""
        a, b, c, d = self.coef_u
        u = self.u_lo + (np.arange(self.width) + kx) * self.u_step
        xi = (a + b * u) / (c + d * u)
        a, b, c, d = self.coef_v
        v = self.v_lo + (np.arange(self.height) + ky) * self.v_step
        eta = (a + b * v) / (c + d * v)
        return (
            (self.sign * xi).astype(np.float32),
            (self.sign * eta).astype(np.float32),
        )


def inter_dims(width: int, height: int, oversample: float = 1.5):
    """Intermediate lattice dims for a screen size (``oversample`` covers
    the frustum-bbox growth of a tilted view plus the residual cross-axis
    density variation)."""

    def up(n, m):
        return -(-n // m) * m

    iw = up(int(np.ceil(width * oversample)), 128 if width >= 128 else 8)
    ih = up(int(np.ceil(height * oversample)), 8)
    return iw, ih


def _center_map(d00, dstep, dother, mid, num_comp):
    """1-D projective map q -> (a + b q)/(c + d q) of the ray coordinate
    ``num_comp``/z along one screen axis, at the other axis' midline."""
    a = d00[num_comp] + mid * dother[num_comp]
    b = dstep[num_comp]
    c = d00[0] + mid * dother[0]
    d = dstep[0]
    return a, b, c, d


def _solve_axis(coef, lo, hi, n):
    """(q_lo, q_step) so the lattice xi(q_lo + i q_step), i in [0, n),
    covers [lo, hi] with _PAD cells of margin; None when the map's pole
    falls inside the range."""
    a, b, c, d = coef

    def inv(xi):
        den = b - xi * d
        if abs(den) < 1e-30:
            return None
        return (xi * c - a) / den

    u0 = inv(lo)
    u1 = inv(hi)
    if u0 is None or u1 is None:
        return None
    q_lo, q_hi = min(u0, u1), max(u0, u1)
    step = max(q_hi - q_lo, 1e-12) / (n - 1 - 2 * _PAD)
    q_lo -= _PAD * step
    q_hi += _PAD * step
    if abs(d) > 1e-30:
        pole = -c / d
        if q_lo - step <= pole <= q_hi + step:
            return None
    return q_lo, step


def _solve_axis_uniform(lo, hi, n):
    """Uniform-xi lattice covering [lo, hi] (identity map, coef
    (0, 1, 1, 0)): the fallback when the adaptive map's pole lands inside
    the corner range (strong tilt)."""
    step = max(hi - lo, 1e-12) / (n - 1 - 2 * _PAD)
    return lo - _PAD * step, step, (0.0, 1.0, 1.0, 0.0)


def setup_shearwarp(
    camera: Camera, axis: int, width: int, height: int,
    iw: int, ih: int, min_rz: float = 0.05,
):
    """Factorize ``camera`` (voxel frame) for a sweep along ``axis``.

    Returns a ShearWarp, or None when the frustum is too oblique (a corner
    ray changes the sign of rz, or |rz|/|r| < ``min_rz``)."""
    pos_p, d00_p, du_p, dv_p = (
        np.asarray(v, np.float64) for v in permute_camera(camera, axis)
    )
    corners = []
    for u, v in ((0.0, 0.0), (width, 0.0), (0.0, height), (width, height)):
        corners.append(d00_p + u * du_p + v * dv_p)
    corners = np.stack(corners)  # (4, 3) in (z, y, x) order
    rz = corners[:, 0]
    rn = np.linalg.norm(corners, axis=1)
    if np.any(rz > 0) and np.any(rz < 0):
        return None
    if np.min(np.abs(rz) / rn) < min_rz:
        return None
    s = 1.0 if rz[0] > 0 else -1.0

    xi = corners[:, 2] / rz
    eta = corners[:, 1] / rz
    coef_u = _center_map(d00_p, du_p, dv_p, height / 2.0, 2)
    coef_v = _center_map(d00_p, dv_p, du_p, width / 2.0, 1)
    su = _solve_axis(coef_u, float(xi.min()), float(xi.max()), iw)
    sv = _solve_axis(coef_v, float(eta.min()), float(eta.max()), ih)
    if su is None:
        u_lo, u_step, coef_u = _solve_axis_uniform(
            float(xi.min()), float(xi.max()), iw
        )
    else:
        u_lo, u_step = su
    if sv is None:
        v_lo, v_step, coef_v = _solve_axis_uniform(
            float(eta.min()), float(eta.max()), ih
        )
    else:
        v_lo, v_step = sv

    # un-permute the sweep direction to the voxel frame: grid slot g
    # holds world axis perm[g] (permute_camera)
    other = [a for a in (2, 1, 0) if a != axis]
    perm = (axis, *other)

    def unperm(p_vec):
        w = np.zeros(3)
        for g in range(3):
            w[perm[g]] = p_vec[g]
        return w.astype(np.float32)

    cam_i = Camera(
        pos=np.asarray(camera.pos, np.float32),
        dir00=unperm(np.array([s, 0.0, 0.0])),
        dir_du=np.zeros(3, np.float32),
        dir_dv=np.zeros(3, np.float32),
    )

    # screen->lattice map over CENTERED screen coords (uc, vc, 1):
    #   xi(u, v) = Nx.q / Dz.q  (affine rows from the camera vectors)
    #   u_xi = (c Nx - a Dz) / (b Dz - d Nx)   (invert the 1-D map)
    #   i = (u_xi - u_lo) / u_step
    def rows(num_comp):  # affine rows over centered (uc, vc, 1)
        return np.array([
            du_p[num_comp], dv_p[num_comp],
            d00_p[num_comp]
            + (width / 2.0) * du_p[num_comp]
            + (height / 2.0) * dv_p[num_comp],
        ])

    n_x, n_y, d_z = rows(2), rows(1), rows(0)

    def compose(coef, n_row, q_lo, q_step):
        a, b, c, d = coef
        num = (c * n_row - a * d_z) - q_lo * (b * d_z - d * n_row)
        den = q_step * (b * d_z - d * n_row)
        sc = max(np.abs(den).max(), 1e-30)
        return np.stack([num / sc, den / sc])

    hom = np.stack([
        compose(coef_u, n_x, u_lo, u_step),
        compose(coef_v, n_y, v_lo, v_step),
    ])
    return ShearWarp(
        camera=cam_i, width=iw, height=ih, hom=hom, axis=axis, sign=s,
        u_lo=u_lo, u_step=u_step, coef_u=tuple(map(float, coef_u)),
        v_lo=v_lo, v_step=v_step, coef_v=tuple(map(float, coef_v)),
        screen=(width, height),
    )


def _warp_coords(sw: ShearWarp, width, height, jx, jy, shift_i, shift_j,
                 device):
    """Lattice coordinates (i, j), each (H, W) float32, of the jittered
    screen pixel centers."""
    f32 = torch.float32
    hom = torch.from_numpy(np.asarray(sw.hom, np.float32)).to(device)
    uu = torch.arange(width, dtype=f32, device=device)[None, :] + (
        jx - width / 2.0)
    vv = torch.arange(height, dtype=f32, device=device)[:, None] + (
        jy - height / 2.0)
    i = (hom[0, 0, 0] * uu + hom[0, 0, 1] * vv + hom[0, 0, 2]) / (
        hom[0, 1, 0] * uu + hom[0, 1, 1] * vv + hom[0, 1, 2]
    ) - shift_i
    j = (hom[1, 0, 0] * uu + hom[1, 0, 1] * vv + hom[1, 0, 2]) / (
        hom[1, 1, 0] * uu + hom[1, 1, 1] * vv + hom[1, 1, 2]
    ) - shift_j
    return i, j


def warp_bicubic(rgba_i, sw: ShearWarp, width: int, height: int,
                 jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0):
    """Tensor-product Catmull-Rom warp (the fallback where
    ``warp_windows`` admits no two-pass window).  Output is clamped to
    the valid range: rgb >= 0, alpha in [0, 1]."""
    iw, ih = sw.width, sw.height
    i, j = _warp_coords(sw, width, height, jx, jy, shift_i, shift_j,
                        rgba_i.device)
    i = torch.clamp(i, 1.0, iw - 2.0 - 1e-4)
    j = torch.clamp(j, 1.0, ih - 2.0 - 1e-4)
    i0 = torch.floor(i).to(torch.int64)
    j0 = torch.floor(j).to(torch.int64)
    fi = (i - i0.to(torch.float32)).reshape(-1)[None]
    fj = (j - j0.to(torch.float32)).reshape(-1)[None]

    c = rgba_i.shape[1]
    img = rgba_i.T.reshape(c, ih * iw)
    base = (j0 * iw + i0).reshape(-1)

    def cr(t):  # Catmull-Rom weights at offsets -1, 0, 1, 2
        t2 = t * t
        t3 = t2 * t
        return (
            -0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2,
        )

    wx = cr(fi)
    wy = cr(fj)
    out = 0.0
    for b in range(4):
        row = 0.0
        for a in range(4):
            row = row + wx[a] * img[:, base + (b - 1) * iw + (a - 1)]
        out = out + wy[b] * row
    if c == 4:
        out = torch.cat([torch.clamp(out[:3], min=0.0),
                         torch.clamp(out[3:4], 0.0, 1.0)], dim=0)
    else:
        out = torch.clamp(out, min=0.0)
    return out.T


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


def warp_two_pass_reference(rgba_i, sw, width: int, height: int, bi: int,
                            bj: int, jx=0.5, jy=0.5, shift_i=0.0,
                            shift_j=0.0):
    """K2a + K2b in plain torch.  rgba_i: (iw*ih, C) from the sweep.
    Returns (width*height, C)."""
    params = warp_params(sw, jx, jy, shift_i, shift_j)
    wj0, wi0 = window_starts(params, sw, width, height, bi, bj)
    v_img = warp_pass1_reference(rgba_i, wj0, params, sw, height, bj)
    return warp_pass2_reference(v_img, wi0, params, sw, width, height, bi)


def warp_image(rgba_i, sw: ShearWarp, width: int, height: int,
               jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0):
    """The two-pass warp where ``warp_windows`` admits it, else the
    bicubic gather."""
    wb = warp_windows(sw, width, height)
    if wb is not None:
        return warp_two_pass_reference(rgba_i, sw, width, height, *wb,
                                       jx=jx, jy=jy, shift_i=shift_i,
                                       shift_j=shift_j)
    return warp_bicubic(rgba_i, sw, width, height, jx=jx, jy=jy,
                        shift_i=shift_i, shift_j=shift_j)

"""Exact arbitrary-camera fast path: shear-warp factorization of the
slab sweep (the port of ``owlexabrick_tpu/render/shearwarp.py``).

The slab sweep renders any camera whose rays form a separable monotone
lattice in normalized ray space (xi, eta) = (rx/rz, ry/rz) once the sweep
axis is permuted to z.  A tilted perspective camera shares its eye with
an *intermediate* lattice camera that spans the frustum's (xi, eta)
bounding box; the screen image is then one 2-D projective warp of the
intermediate image (Lacroute & Levoy 1994).  Volume sampling stays the
aligned sweep's (K1 on the card); the only approximation is the final
image resample, which is the two-pass Catmull-Rom warp (K2a + K2b,
``render/warp.py``) where ``warp_windows`` admits the map, else the
tensor-product bicubic gather, as in the JAX package.

The lattice is perspective-adaptive: columns are uniform in center-row
screen u and rows uniform in center-column screen v, so the lattice's
density stays near the oversample factor under strong tilt.  The host
factorization is float64 numpy, identical to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .camera import Camera
from .slabs import permute_camera, render_slabs_camera

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


def warp_bilinear(rgba_i, sw: ShearWarp, width: int, height: int,
                  jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0):
    """Resample the intermediate image to the screen (bilinear).

    rgba_i: (iw*ih, C) row-major from render_slabs_camera.  jx/jy: screen
    sub-pixel jitter; shift_i/shift_j: the lattice phase used in
    ShearWarp.lattice(kx, ky).  Returns (width*height, C)."""
    iw, ih = sw.width, sw.height
    i, j = _warp_coords(sw, width, height, jx, jy, shift_i, shift_j,
                        rgba_i.device)
    i = torch.clamp(i, 0.0, iw - 1.0)
    j = torch.clamp(j, 0.0, ih - 1.0)
    i0 = torch.clamp(torch.floor(i).to(torch.int64), 0, iw - 2)
    j0 = torch.clamp(torch.floor(j).to(torch.int64), 0, ih - 2)
    fi = (i - i0.to(torch.float32)).reshape(-1)[None]
    fj = (j - j0.to(torch.float32)).reshape(-1)[None]

    c = rgba_i.shape[1]
    img = rgba_i.T.reshape(c, ih * iw)  # components lead
    base = (j0 * iw + i0).reshape(-1)  # (P,)

    def tap(off):
        return img[:, base + off]  # (C, P)

    out = (
        tap(0) * (1 - fi) * (1 - fj)
        + tap(1) * fi * (1 - fj)
        + tap(iw) * (1 - fi) * fj
        + tap(iw + 1) * fi * fj
    )
    return out.T  # (P, C)


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


def warp_image(rgba_i, sw: ShearWarp, width: int, height: int,
               jx=0.5, jy=0.5, shift_i=0.0, shift_j=0.0,
               plain: bool = False):
    """Default warp: the two-pass warp (K2a + K2b on the card) when the
    homography's derivative bounds fit a window bucket (``warp_windows``),
    otherwise the bicubic gather — the same choice as the JAX package.
    ``plain`` runs the two-pass warp's plain-torch version on CUDA
    tensors too (the comparison lane)."""
    from .warp import warp_two_pass, warp_windows

    wb = warp_windows(sw, width, height)
    if wb is not None:
        return warp_two_pass(rgba_i, sw, width, height, *wb, jx=jx, jy=jy,
                             shift_i=shift_i, shift_j=shift_j, plain=plain)
    return warp_bicubic(rgba_i, sw, width, height, jx=jx, jy=jy,
                        shift_i=shift_i, shift_j=shift_j)


def render_slabs_shearwarp(grids, fs, cfg, camera, width: int, height: int,
                           sw: ShearWarp | None = None, t_stop=None,
                           jx=0.5, jy=0.5, oversample: float = 1.5,
                           filter: str = "auto", camera_cache=None):
    """Render an arbitrarily oriented camera exactly through the sweep.

    ``camera`` is in voxel space; ``grids.axis`` selects the sweep axis.
    ``t_stop`` is per *intermediate* pixel (a surface pass runs on the
    lattice rays).  ``filter`` picks the warp: "auto" (``warp_image``),
    "bicubic" or "bilinear".  Returns (width*height, 4) rgba.  Raises
    ValueError when the frustum is too oblique for this axis.
    ``cfg.plain_sweep`` runs the plain versions of both the sweep and the
    warp."""
    warps = {"auto": warp_image, "bicubic": warp_bicubic,
             "bilinear": warp_bilinear}
    if filter not in warps:
        raise ValueError(f"filter must be one of {sorted(warps)}, got "
                         f"{filter!r}")
    if sw is None:
        iw, ih = inter_dims(width, height, oversample)
        sw = setup_shearwarp(camera, grids.axis, width, height, iw, ih)
        if sw is None:
            raise ValueError(
                "camera too oblique for shear-warp along this axis"
            )
    rgba_i = render_slabs_camera(
        grids, fs, cfg, sw.camera, sw.width, sw.height, t_stop=t_stop,
        lattice=sw.lattice(), camera_cache=camera_cache,
    )
    if filter == "auto":
        return warp_image(rgba_i, sw, width, height, jx=jx, jy=jy,
                          plain=cfg.plain_sweep)
    return warps[filter](rgba_i, sw, width, height, jx=jx, jy=jy)

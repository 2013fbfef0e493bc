"""Transfer-function lookup, culling and knot compression (frozen copies
of the port's ``render/xf.py`` lookups and of ``slabs.compress_pwl``,
host numpy and plain torch)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

NUM_XF_VALUES = 128


def lookup_xf(lut: torch.Tensor, domain, opacity_scale, value: torch.Tensor):
    """Vectorized XF lookup (exabrick.cu:136-150 + tex1D lerp).

    lut: (N, 4) for one channel; domain: (2,); value: any shape.
    Returns value.shape + (4,) RGBA with alpha scaled by opacity_scale.
    """
    n = lut.shape[-2]
    lo = domain[..., 0]
    hi = domain[..., 1]
    scalar = (n - 1) * (value - lo) / ((hi - lo) + 1e-20)
    scalar = torch.clamp(scalar + 0.5, 0.0, n - 1.0) / (n - 1.0)
    # CUDA tex1D linear filtering with clamp addressing
    u = scalar * n - 0.5
    i0 = torch.floor(u)
    frac = (u - i0)[..., None]
    i0_int = i0.to(torch.int64)
    i0 = torch.clamp(i0_int, 0, n - 1)
    i1 = torch.clamp(i0_int + 1, 0, n - 1)
    rgba = lut[i0] * (1.0 - frac) + lut[i1] * frac
    alpha = rgba[..., 3:4] * opacity_scale
    return torch.cat([rgba[..., :3], alpha], dim=-1)


def active_for_volume_sampling(lut: torch.Tensor, domain, opacity_scale,
                               value_range: torch.Tensor) -> torch.Tensor:
    """Per-region transfer-function culling mask for one channel: whether
    any LUT entry over the region's value range has non-zero opacity —
    activeForVolumeSampling (programs/exabrick.cu:250-281), vectorized
    over regions.

    lut: (N, 4); domain: (2,) tensor; value_range: (..., 2).  Returns
    (...,) bool."""
    n = lut.shape[-2]
    lo = domain[0]
    hi = domain[1]
    vr_lo = value_range[..., 0]
    vr_hi = value_range[..., 1]
    inside = ~((vr_lo > hi) | (vr_hi < lo))

    scaled_lo = (vr_lo - lo) / ((hi - lo) + 1e-20)
    scaled_hi = (vr_hi - lo) / ((hi - lo) + 1e-20)
    # float -> int truncation toward zero, like astype(int32); +-inf bounds
    # (empty ranges) are clamped before the cast so they stay defined
    big = float(n + 1)
    idx_lo = torch.clamp(
        torch.clamp(scaled_lo * (n - 1), -big, big).to(torch.int32), 0, n - 1)
    idx_hi = torch.clamp(
        torch.clamp(scaled_hi * (n - 1), -big, big).to(torch.int32) + 1,
        0, n - 1)

    # evaluate every LUT entry's alpha through the same lookup the
    # renderer uses, then test the [idx_lo, idx_hi] slice per region
    i = torch.arange(n, dtype=torch.float32, device=lut.device)
    cell_values = i / (n - 1) * (hi - lo) + lo
    alphas = lookup_xf(lut, torch.stack([lo, hi]), opacity_scale,
                       cell_values)[..., 3]
    in_slice = (i >= idx_lo[..., None]) & (i <= idx_hi[..., None])
    any_alpha = torch.any(in_slice & (alphas > 0.0), dim=-1)
    return inside & any_alpha


# ---- knot compression --------------------------------------------------

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

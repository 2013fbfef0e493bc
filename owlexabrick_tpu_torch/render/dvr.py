"""Frame finishing (the port of ``owlexabrick_tpu/render/dvr.py:462-507``):
sRGB conversion, background composite, progressive accumulation
(exabrick.cu:1709-1719) and RGBA8 packing (exabrick.cu:62-76); and the
ray-box slab test (``dvr.py:127-136``) the clip box uses."""

from __future__ import annotations

import torch


def ray_box(o, d, lo, hi, tmin, tmax):
    """Slab test of rays o + t d (d (P, 3); o (P, 3), or (3,) for one
    eye) against the box [lo, hi] (3,), clipped to [tmin, tmax] (P,);
    returns (hit, t0, t1), float32 like the reference's."""
    inv = 1.0 / d
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    t_nr = torch.minimum(t_lo, t_hi)
    t_fr = torch.maximum(t_lo, t_hi)
    t0 = torch.maximum(tmin, t_nr.amax(dim=-1))
    t1 = torch.minimum(tmax, t_fr.amin(dim=-1))
    return t0 < t1, t0, t1


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.0031308, 12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-20), 1 / 2.4) - 0.055)


def composite_background(rgba: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    w = rgba[:, 3:4]
    return w * rgba[:, :3] + (1.0 - w) * bg


def accumulate(color: torch.Tensor, accum: torch.Tensor, frame_id: int):
    """Progressive accumulation.  Returns (new_accum (P, 4),
    display color in sRGB (P, 3))."""
    if frame_id > 0:
        color = color + accum[:, :3]
    new_accum = torch.cat([color, torch.ones_like(color[:, :1])], dim=1)
    shown = color / (frame_id + 1.0)
    return new_accum, linear_to_srgb(shown)


def pack_rgba8(color_srgb: torch.Tensor) -> torch.Tensor:
    """(P, 3) float -> (P,) RGBA8 words (int64 holding uint32 values)."""
    c = torch.clamp((color_srgb * 256.0).to(torch.int32), 0, 255).to(
        torch.int64)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | 0xFF000000

"""Benchmark scenes (the port of ``owlexabrick_tpu/bench_scene.py:13-97,
207``): a synthetic multi-level AMR volume -> raw2cells threshold
collapse -> level grids; the exajet pattern also as streamed cells; and
seeded surfaces to place in them (a bumpy-sphere mesh, a bundle of
streamline helices).

``slab_scene_grids`` builds the level grids straight from the cells
(``level_grids_from_cells``): the bricks only partition the cells and
the basis lives on the cells, so the brick builder is skipped.  Nothing
is cached on disk; the scene is made anew in every run.
"""

from __future__ import annotations

import time

import numpy as np

from .core.types import TriangleMesh
from .render.slabs import level_grids_from_cells
from .render.tracer import morton_order
from .tools.raw2cells import volume_to_cells


def synthetic_volume(n: int = 64) -> np.ndarray:
    """Smooth multi-scale field: blobs + a shell, gives a real AMR level
    mix under threshold collapse."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    z = ax[:, None, None]
    y = ax[None, :, None]
    x = ax[None, None, :]
    r = np.sqrt(x * x + y * y + z * z)
    v = np.exp(-18 * ((x - 0.3) ** 2 + (y - 0.2) ** 2 + z ** 2))
    v = v + 0.8 * np.exp(-24 * ((x + 0.4) ** 2 + y ** 2 + (z - 0.3) ** 2))
    v += 0.6 * np.exp(-60 * (r - 0.7) ** 2)
    return np.asarray(v, np.float32)


def _exajet_field(z, y, x, n: int, wings: int = 1) -> np.ndarray:
    """The exajet-pattern analytic field on broadcastable (z, y, x) grids
    in [-1, 1] units: ``wings`` thin wavy sheets with a sharp gradient
    across each, in a smooth background whose per-coarse-cell variation
    stays below the raw2cells collapse threshold (0.004), so only the
    sheets force refinement (geometry-fitted AMR)."""
    w = np.float32(6.0 / n)  # a few finest cells thick
    sheet = 0.25 * np.sin(2.4 * x) * np.cos(1.7 * z) - 0.15 * x
    d = y - sheet
    v = 1.0 / (1.0 + np.exp(np.clip(-d / w, -60.0, 60.0)))
    if wings >= 2:
        # a second wing, phase-shifted so the sheets stay apart in y
        sheet2 = (0.2 * np.sin(2.4 * x + 2.0) * np.cos(1.7 * z + 1.1)
                  + 0.45 - 0.1 * x)
        d2 = y - sheet2
        v += 1.0 / (1.0 + np.exp(np.clip(-d2 / w, -60.0, 60.0)))
    v += 0.04 * np.exp(-2.0 * (x * x + z * z))
    v += 0.02 * np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2 + z * z))
    return np.asarray(v, np.float32)


def exajet_pattern_volume(n: int = 256, wings: int = 1) -> np.ndarray:
    """Exajet-pattern field as a dense (n, n, n) volume: under threshold
    collapse the finest level hugs the wing sheets (fine cells on
    geometry, coarse everywhere else)."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    return _exajet_field(ax[:, None, None], ax[None, :, None],
                         ax[None, None, :], n, wings)


def exajet_pattern_cells(n: int, threshold: float = 0.004,
                         max_level: int = 3, wings: int = 1):
    """The cells of ``exajet_pattern_volume(n, wings)`` without the dense
    volume (4 GB at 1024^3): the raw2cells collapse is local to
    2^max_level-aligned root blocks, so the field streams in z slices of
    2^max_level planes, each collapsed on its own with its cells' z
    offset.  Equal to ``volume_to_cells(exajet_pattern_volume(n, wings),
    threshold, max_level)``.  Returns (lower (N, 3) int32, level,
    scalars)."""
    w = 1 << max_level
    if n % w:
        raise ValueError(f"n={n} must be a multiple of 2^max_level={w}")
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    y = ax[None, :, None]
    x = ax[None, None, :]
    lowers, levels, scals = [], [], []
    for z0 in range(0, n, w):
        v = _exajet_field(ax[z0:z0 + w][:, None, None], y, x, n, wings)
        lo, lv, sc = volume_to_cells(v, threshold, max_level)
        lo[:, 2] += z0
        lowers.append(lo)
        levels.append(lv)
        scals.append(sc)
    return (np.concatenate(lowers), np.concatenate(levels),
            np.concatenate(scals))


def slab_scene_grids(kind: str, n: int, threshold: float = 0.004,
                     max_level: int = 3, device="cuda", wings: int = 1):
    """Level grids (sweep axis z) of the ``kind`` ("blobs" or "exajet",
    with ``wings`` sheets) bench scene at ``n``^3, on ``device`` (the
    card unless the caller asks for the CPU).  Returns (grids, meta) with
    n_cells, build_s and value_max."""
    t0 = time.time()
    vol = (exajet_pattern_volume(n, wings) if kind == "exajet"
           else synthetic_volume(n))
    lower, level, scal = volume_to_cells(vol, threshold, max_level)
    grids = level_grids_from_cells(lower, level, scal[None], axis=2,
                                   device=device)
    meta = dict(n_cells=int(lower.shape[0]),
                build_s=round(time.time() - t0, 1),
                value_max=float(scal.max()))
    return grids, meta


def bumpy_sphere(radius: float = 14.0, center=(0.0, 0.0, 0.0), nu: int = 72,
                 nv: int = 72, seed: int = 0) -> TriangleMesh:
    """A bumpy sphere of 2 nu (nv - 1) triangles (the JAX package's
    tiled-trace test mesh, tests/test_streamline_tiled.py::_big_mesh:
    radius 14 +- 2, vertices jittered by a seeded N(0, 0.05)), scaled by
    ``radius`` / 14 about its center and moved to ``center``."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = 14.0 + 2.0 * np.sin(3 * uu) * np.sin(4 * vv)
    verts = np.stack([r * np.sin(vv) * np.cos(uu), r * np.cos(vv),
                      r * np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    verts = verts.astype(np.float32)
    verts += rng.normal(0, 0.05, verts.shape).astype(np.float32)
    verts = (verts * np.float32(radius / 14.0)
             + np.asarray(center, np.float32))
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None]
    a = i * nv + j
    b = (i + 1) % nu * nv + j
    idx = np.stack([np.stack([a, b, a + 1], -1),
                    np.stack([b, b + 1, a + 1], -1)], 2).reshape(-1, 3)
    return TriangleMesh(vertices=verts.astype(np.float32),
                        indices=idx.astype(np.int32))


def helix_bundle(n: int, count: int = 64, segments: int = 64,
                 turns: float = 2.0):
    """``count`` streamline helices on a square grid over an n^3 volume,
    each ``segments`` segments climbing z from 0.1n to 0.9n at radius
    0.04n, in the tracer's emission order (helices by the Morton code of
    their first point, seed-major).  Returns (seg_a (S, 3), seg_b (S, 3),
    seg_t (S,) int32: the timestep of each segment's head, 1..segments
    along a helix)."""
    side = int(np.ceil(np.sqrt(count)))
    cx = n * (0.1 + 0.8 * (np.arange(count) % side + 0.5) / side)
    cy = n * (0.1 + 0.8 * (np.arange(count) // side + 0.5) / side)
    s = np.linspace(0.0, 1.0, segments + 1)
    ang = 2 * np.pi * turns * s[None] + np.arange(count)[:, None]
    pts = np.stack([cx[:, None] + 0.04 * n * np.cos(ang),
                    cy[:, None] + 0.04 * n * np.sin(ang),
                    np.broadcast_to(n * (0.1 + 0.8 * s), ang.shape)],
                   -1).astype(np.float32)
    pts = pts[morton_order(pts[:, 0])]
    seg_t = np.tile(np.arange(1, segments + 1, dtype=np.int32), count)
    return (pts[:, :-1].reshape(-1, 3), pts[:, 1:].reshape(-1, 3), seg_t)

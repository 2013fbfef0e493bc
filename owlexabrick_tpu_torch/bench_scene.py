"""Benchmark scenes (the port of ``owlexabrick_tpu/bench_scene.py:13,
52, 207``): a synthetic multi-level AMR volume -> raw2cells threshold
collapse -> level grids.

``slab_scene_grids`` builds the level grids straight from the cells
(``level_grids_from_cells``): the bricks only partition the cells and
the basis lives on the cells, so the brick builder is skipped.  Nothing
is cached on disk; the scene is made anew in every run.
"""

from __future__ import annotations

import time

import numpy as np

from .render.slabs import level_grids_from_cells
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


def exajet_pattern_volume(n: int = 256) -> np.ndarray:
    """Exajet-pattern field as a dense (n, n, n) volume in [-1, 1]: a
    thin wavy sheet with a sharp gradient across it, in a smooth
    background below the collapse threshold, so only the sheet forces
    refinement (geometry-fitted AMR; one wing of the JAX package's
    ``_exajet_field``)."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    w = np.float32(6.0 / n)
    sheet = 0.25 * np.sin(2.4 * x) * np.cos(1.7 * z) - 0.15 * x
    d = y - sheet
    v = 1.0 / (1.0 + np.exp(np.clip(-d / w, -60.0, 60.0)))
    v += 0.04 * np.exp(-2.0 * (x * x + z * z))
    v += 0.02 * np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2 + z * z))
    return np.asarray(v, np.float32)


def slab_scene_grids(kind: str, n: int, threshold: float = 0.004,
                     max_level: int = 3, device="cuda"):
    """Level grids (sweep axis z) of the ``kind`` ("blobs" or "exajet")
    bench scene at ``n``^3, on ``device`` (the card unless the caller
    asks for the CPU).  Returns (grids, meta) with n_cells, build_s and
    value_max."""
    t0 = time.time()
    vol = exajet_pattern_volume(n) if kind == "exajet" else synthetic_volume(n)
    lower, level, scal = volume_to_cells(vol, threshold, max_level)
    grids = level_grids_from_cells(lower, level, scal[None], axis=2,
                                   device=device)
    meta = dict(n_cells=int(lower.shape[0]),
                build_s=round(time.time() - t0, 1),
                value_max=float(scal.max()))
    return grids, meta

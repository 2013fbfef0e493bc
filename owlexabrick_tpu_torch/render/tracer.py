"""The particle tracer's host helpers (the port of the jax-free part of
``owlexabrick_tpu/render/tracer.py``).  The RK4 tracer itself samples the
exact scene, which the port does not have yet."""

from __future__ import annotations

import numpy as np


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation sorting (N, 3) points along a 3D Z-curve (10 bits per
    axis over the point AABB).  ``SurfaceData.from_meshes`` orders
    triangles by it so the tiled traces' chunk bounding spheres stay
    tight (render/surfaces.py): a pure reordering, render semantics
    (nearest hit over the set) unchanged."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(0)
    ext = np.maximum(pts.max(0) - lo, 1e-30)
    q = np.minimum((pts - lo) / ext * 1023.0, 1023.0).astype(np.uint64)

    def _spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1)) \
        | (_spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")

"""Host dataclasses of the exa-brick data model (the jax-free copies of
``owlexabrick_tpu/core/types.py``'s that the port needs)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TriangleMesh:
    """A triangle surface mesh (exa/TriangleMesh.h:23-38)."""

    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (T, 3) int32

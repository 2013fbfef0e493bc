"""Parser for the ``.exa`` scene-config DSL (the port's copy of
``owlexabrick_tpu/io/config.py``, host numpy).

Token grammar (reference exa/Config.cpp:57-180): whitespace-separated
tokens, ``#`` starts a comment that runs to end of line.  Recognized
directives:

  * ``bricks <file.bricks>``
  * ``scalar <name> <file.scalars>``
  * ``scalar <name> expr "<postfix tokens>"``
  * ``vector <name> <fx> <fy> <fz>``      (magnitude field)
  * ``value_range <lo> <hi>``             (applies to the last field)
  * ``triangles <file.tris>``
  * ``remap_from x0 y0 z0 x1 y1 z1`` / ``remap_to ...`` (world<->voxel remap)

File paths are relative to the config file's directory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dfield
from typing import List, Optional, Tuple

import numpy as np

from ..core.types import Bricks, ScalarField, TriangleMesh
from . import formats
from .expression import evaluate_postfix


@dataclass
class Config:
    bricks: Optional[Bricks] = None
    cell_ids: Optional[np.ndarray] = None
    scalar_fields: List[ScalarField] = dfield(default_factory=list)
    surfaces: List[TriangleMesh] = dfield(default_factory=list)
    # identity remap unless remap_from/remap_to given
    remap_from: Optional[Tuple[np.ndarray, np.ndarray]] = None
    remap_to: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def voxel_from_world(self) -> np.ndarray:
        """World->voxel affine as a (3,4) [A|b] matrix.

        voxelSpaceTransform = T(voxel_lo) S(voxel_span) (T(world_lo) S(world_span))^-1
        (reference exa/Config.cpp:23-44); identity when no remap given.
        """
        A = np.eye(3, dtype=np.float64)
        b = np.zeros(3, dtype=np.float64)
        if self.remap_from is not None and self.remap_to is not None:
            v_lo, v_hi = self.remap_from
            w_lo, w_hi = self.remap_to
            v_span = np.asarray(v_hi, np.float64) - np.asarray(v_lo, np.float64)
            w_span = np.asarray(w_hi, np.float64) - np.asarray(w_lo, np.float64)
            s = v_span / w_span
            A = np.diag(s)
            b = np.asarray(v_lo, np.float64) - s * np.asarray(w_lo, np.float64)
        out = np.zeros((3, 4), dtype=np.float32)
        out[:, :3] = A
        out[:, 3] = b
        return out

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Voxel-space model bounds mapped back to world space
        (exa/Config.cpp:48-55)."""
        if self.bricks is None:
            raise ValueError("config has no bricks")
        lo, hi = self.bricks.bounds()
        v_lo = lo.min(axis=0)
        v_hi = hi.max(axis=0)
        m = self.voxel_from_world().astype(np.float64)
        A = m[:, :3]
        b = m[:, 3]
        inv_a = np.linalg.inv(A)
        w_lo = inv_a @ (v_lo - b)
        w_hi = inv_a @ (v_hi - b)
        return w_lo.astype(np.float32), w_hi.astype(np.float32)

    def voxel_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.bricks is None:
            raise ValueError("config has no bricks")
        lo, hi = self.bricks.bounds()
        return lo.min(axis=0), hi.max(axis=0)


def _tokenize(path: str) -> List[str]:
    tokens: List[str] = []
    with open(path) as f:
        for line in f:
            for tok in line.split():
                if tok.startswith("#"):
                    break
                tokens.append(tok)
    return tokens


def parse_config(path: str) -> Config:
    cfg = Config()
    base = os.path.dirname(os.path.abspath(path))
    toks = _tokenize(path)
    i = 0

    def vec3(j):
        return np.asarray([float(toks[j]), float(toks[j + 1]), float(toks[j + 2])],
                          dtype=np.float32)

    while i < len(toks):
        t = toks[i]
        if t == "remap_from":
            cfg.remap_from = (vec3(i + 1), vec3(i + 4))
            i += 7
        elif t == "remap_to":
            cfg.remap_to = (vec3(i + 1), vec3(i + 4))
            i += 7
        elif t == "scalar":
            name = toks[i + 1]
            if toks[i + 2] == "expr":
                i += 3
                expr_toks: List[str] = []
                while True:
                    expr_toks.append(toks[i])
                    if toks[i].endswith('"'):
                        break
                    i += 1
                i += 1
                values = evaluate_postfix(
                    expr_toks, [f.values for f in cfg.scalar_fields]
                )
                cfg.scalar_fields.append(ScalarField.from_values(name, values))
            else:
                fn = os.path.join(base, toks[i + 2])
                i += 3
                cfg.scalar_fields.append(
                    ScalarField.from_values(name, formats.read_scalars(fn))
                )
        elif t == "vector":
            name = toks[i + 1]
            comps = [formats.read_scalars(os.path.join(base, toks[i + 1 + k]))
                     for k in (1, 2, 3)]
            i += 5
            mag = np.sqrt(sum(c.astype(np.float64) ** 2 for c in comps))
            cfg.scalar_fields.append(
                ScalarField.from_values(name, mag.astype(np.float32))
            )
        elif t == "value_range":
            if not cfg.scalar_fields:
                raise ValueError("value_range before any scalar field")
            cfg.scalar_fields[-1].value_range = (float(toks[i + 1]), float(toks[i + 2]))
            i += 3
        elif t == "bricks":
            cfg.bricks, cfg.cell_ids = formats.read_bricks(
                os.path.join(base, toks[i + 1])
            )
            i += 2
        elif t == "triangles":
            cfg.surfaces = formats.read_tris(os.path.join(base, toks[i + 1]))
            i += 2
        else:
            raise ValueError(f"error in parsing config file: unknown token '{t}'")
    return cfg

"""exaArtificial: synthetic AMR dataset generator (test fixture maker; the
port's copy of ``owlexabrick_tpu/tools/artificial.py``).

    python -m owlexabrick_tpu_torch.tools.artificial <grids.txt> [-o outbase]

Reads a text file of subgrids, one per line (tools/artificial/artificial.cpp:92-162):
    min0 min1 min2 nx ny nz level v0 [v1 v2 v3 v4 v5 v6 v7]
Each subgrid contributes nx*ny*nz cells at the given level with scalars
trilinearly interpolated between the 8 corner values (v0 everywhere when
only one value is given).  Writes <out>.cells and <out>.scalars.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

from ..io import formats


def grid_cells(min_corner, n, level: int, corner_values) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One subgrid -> (lower (N,3), level (N,), scalars (N,))."""
    min_corner = np.asarray(min_corner, np.int64)
    nx, ny, nz = (int(n[0]), int(n[1]), int(n[2]))
    cw = 1 << int(level)
    v = np.asarray(corner_values, np.float32).reshape(8)

    # cell anchors, x fastest (matches the reference's z,y,x loop nest with
    # cells appended x-innermost)
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    lower = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1) * cw + min_corner
    # interpolation coords (artificial.cpp:74-76): relative to full extent
    max_c = min_corner + (np.asarray([nx, ny, nz]) - 1) * cw
    ext = (max_c - min_corner + 1).astype(np.float32)
    x = (lower[:, 0] - min_corner[0]) / ext[0]
    y = (lower[:, 1] - min_corner[1]) / ext[1]
    z = (lower[:, 2] - min_corner[2]) / ext[2]

    def lerp(a, b, t):
        return (1.0 - t) * a + t * b

    s = lerp(
        lerp(lerp(v[0], v[1], x), lerp(v[2], v[3], x), y),
        lerp(lerp(v[4], v[5], x), lerp(v[6], v[7], x), y),
        z,
    ).astype(np.float32)
    levels = np.full(lower.shape[0], level, np.int32)
    return lower.astype(np.int32), levels, s


def parse_grids_text(text: str):
    lowers, levels, scalars = [], [], []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) not in (8, 15):
            continue
        mins = [int(p) for p in parts[:3]]
        n = [int(p) for p in parts[3:6]]
        level = int(parts[6])
        vals = [float(p) for p in parts[7:]]
        if len(vals) == 1:
            vals = vals * 8
        lo, lv, s = grid_cells(mins, n, level, vals)
        lowers.append(lo)
        levels.append(lv)
        scalars.append(s)
    if not lowers:
        raise ValueError("no valid grid lines")
    return (
        np.concatenate(lowers),
        np.concatenate(levels),
        np.concatenate(scalars),
    )


def generate(grid_file: str, out_base: str = "artificial") -> None:
    lower, level, scalars = parse_grids_text(open(grid_file).read())
    formats.write_cells(out_base + ".cells", lower, level)
    formats.write_scalars(out_base + ".scalars", scalars)
    print(f"#exa: wrote {lower.shape[0]} cells to {out_base}.cells/.scalars")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    out = "artificial"
    file_name = None
    i = 0
    while i < len(argv):
        if argv[i] in ("-o", "--o"):
            out = argv[i + 1]
            i += 2
        else:
            file_name = argv[i]
            i += 1
    if file_name is None:
        print("usage: exa-artificial <grids.txt> [-o outbase]")
        return 1
    generate(file_name, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

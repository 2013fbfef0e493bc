"""convertChombo: FLASH-plotfile-style HDF5 (fixed-size blocks) ->
.cells + one scalar file per variable (the port's copy of
``owlexabrick_tpu/tools/chombo.py``; h5py is imported when a file is
converted, never with the module).

Re-implements tools/convertChombo/convertChombo.py: the world->lattice
mapping comes from the smallest box width; every box emits N^3 cells at
level log2(boxWidth/smallestBoxWidth).  Unlike the reference script the
block size N is read from the data (falling back to 8) and file paths are
arguments rather than hardcoded.
"""

from __future__ import annotations

import math
import sys
from typing import Sequence

import numpy as np

from ..io import formats


def convert(path: str, out_base: str,
            variables: Sequence[str] = ("temp", "dens", "velx", "vely", "velz"),
            block_n: int | None = None) -> int:
    import h5py

    with h5py.File(path, "r") as f:
        bboxes = np.asarray(f["bounding box"], np.float64)  # (nb, 3, 2)
        n_boxes = bboxes.shape[0]
        var_data = {}
        for v in variables:
            if v in f:
                var_data[v] = np.asarray(f[v], np.float32)  # (nb, N, N, N)
        if not var_data:
            raise ValueError(f"none of {variables} present in {path}")
        if block_n is None:
            block_n = next(iter(var_data.values())).shape[1]

    widths = bboxes[:, 0, 1] - bboxes[:, 0, 0]
    smallest = float(widths.min())
    origin = bboxes[:, :, 0].min(axis=0)

    lowers, levels = [], []
    for b in range(n_boxes):
        bb_lo = np.round((bboxes[b, :, 0] - origin) / smallest).astype(np.int64)
        level = int(round(math.log2(widths[b] / smallest)))
        cw = 1 << level
        z, y, x = np.meshgrid(*([np.arange(block_n)] * 3), indexing="ij")
        lo = np.stack(
            [cw * (block_n * bb_lo[0] + x.ravel()),
             cw * (block_n * bb_lo[1] + y.ravel()),
             cw * (block_n * bb_lo[2] + z.ravel())], axis=1,
        )
        lowers.append(lo)
        levels.append(np.full(lo.shape[0], level, np.int32))

    lower = np.concatenate(lowers).astype(np.int32)
    level = np.concatenate(levels)
    formats.write_cells(out_base + ".cells", lower, level)
    for v, data in var_data.items():
        formats.write_scalars(
            out_base + "." + v, data.reshape(-1).astype(np.float32)
        )
    print(
        f"#exa: chombo wrote {lower.shape[0]} cells and "
        f"{len(var_data)} scalar files to {out_base}.*"
    )
    return lower.shape[0]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: exa-chombo <file.h5> [-o outbase] [--vars a,b,c]")
        return 1
    path = argv[0]
    out = "chombo"
    variables = ("temp", "dens", "velx", "vely", "velz")
    i = 1
    while i < len(argv):
        if argv[i] == "-o":
            out = argv[i + 1]
            i += 2
        elif argv[i] == "--vars":
            variables = tuple(argv[i + 1].split(","))
            i += 2
        else:
            i += 1
    convert(path, out, variables)
    return 0


if __name__ == "__main__":
    sys.exit(main())

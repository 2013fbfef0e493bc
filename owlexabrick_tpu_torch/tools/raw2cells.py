"""exaRawToCells: structured raw volume -> AMR cells by octree collapse
(the port of ``owlexabrick_tpu/tools/raw2cells.py``, host numpy;
re-implements the reference's tools/fromVolume/raw2cells.cpp:140-245).

    python -m owlexabrick_tpu_torch.tools.raw2cells nx ny nz \
        byte|float|double in.raw outbase threshold maxLevel [refinement=2]

A 2x2x2 block of level-L cells collapses to one level-(L+1) cell when
its value range is within ``threshold``; the collapsed scalar is the
average of the covered input voxels.  Boundary blocks use only their
in-bounds voxels, like the reference.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

from ..io import formats


def volume_to_cells(
    vol: np.ndarray, threshold: float, max_level: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """vol: (nz, ny, nx) float array -> (lower (N,3) int32, level (N,),
    scalars (N,) float32)."""
    vol = np.asarray(vol, np.float64)
    w = 1 << max_level

    def pad_to(a, fill):
        pz = (-a.shape[0]) % w
        py = (-a.shape[1]) % w
        px = (-a.shape[2]) % w
        return np.pad(a, ((0, pz), (0, py), (0, px)), constant_values=fill)

    # pyramids[L] for L = 0..max_level
    mins = [pad_to(vol, np.inf)]
    maxs = [pad_to(vol, -np.inf)]
    sums = [pad_to(vol, 0.0)]
    cnts = [pad_to(np.ones_like(vol), 0.0)]

    def red(a, op):
        s = a.shape
        r = a.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2)
        return op(r, axis=(1, 3, 5))

    for _ in range(max_level):
        mins.append(red(mins[-1], np.min))
        maxs.append(red(maxs[-1], np.max))
        sums.append(red(sums[-1], np.sum))
        cnts.append(red(cnts[-1], np.sum))

    lowers, levels, scalars = [], [], []
    # blocks already covered by a coarser leaf
    covered = np.zeros_like(mins[max_level], dtype=bool)
    for L in range(max_level, -1, -1):
        rng = maxs[L] - mins[L]
        occupied = cnts[L] > 0
        collapsible = (rng <= threshold) | (L == 0)
        leaf = occupied & collapsible & ~covered
        iz, iy, ix = np.nonzero(leaf)
        if iz.size:
            cw = 1 << L
            lowers.append(
                np.stack([ix * cw, iy * cw, iz * cw], axis=1).astype(np.int32)
            )
            levels.append(np.full(iz.size, L, np.int32))
            scalars.append(
                (sums[L][iz, iy, ix] / cnts[L][iz, iy, ix]).astype(np.float32)
            )
        if L > 0:
            nxt = covered | leaf
            covered = np.repeat(np.repeat(np.repeat(nxt, 2, 0), 2, 1), 2, 2)
    return (np.concatenate(lowers), np.concatenate(levels),
            np.concatenate(scalars))


_DTYPES = {"byte": np.uint8, "float": np.float32, "double": np.float64}


def convert(nx: int, ny: int, nz: int, fmt: str, in_file: str,
            out_base: str, threshold: float, max_level: int) -> int:
    dt = _DTYPES[fmt]
    raw = np.fromfile(in_file, dtype=dt, count=nx * ny * nz)
    vol = raw.reshape(nz, ny, nx).astype(np.float64)
    lower, level, scal = volume_to_cells(vol, threshold, max_level)
    formats.write_cells(out_base + ".cells", lower, level)
    formats.write_scalars(out_base + ".scalars", scal)
    frac = 100.0 - lower.shape[0] * 100.0 / (nx * ny * nz)
    print(
        f"#exa: wrote {lower.shape[0]} cells "
        f"({frac:.1f}% compression) to {out_base}.cells/.scalars"
    )
    return lower.shape[0]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (8, 9):
        print(
            "usage: exa-raw2cells nx ny nz byte|float|double in.raw "
            "outbase threshold maxLevel [refinement=2]"
        )
        return 1
    if len(argv) == 9 and int(argv[8]) != 2:
        print("only refinement=2 is supported")
        return 1
    convert(
        int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4],
        argv[5], float(argv[6]), int(argv[7]),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

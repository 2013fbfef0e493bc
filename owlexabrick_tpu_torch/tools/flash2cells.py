"""exaFlashToCells: FLASH4 (Paramesh) HDF5 AMR -> .cells/.scalars (the
port's copy of ``owlexabrick_tpu/tools/flash2cells.py``).

Re-implements tools/fromFlash/flash2cells.cpp: leaf blocks (node type 1)
are projected onto the finest-level integer lattice; cell level =
max_refine_level - block_refine_level; per-variable 4D block data
(nblocks, nzb, nyb, nxb) streams out in z,y,x order.

Requires h5py, imported when a file is read (never with the module).
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np

from ..io import formats


def _require_h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "flash2cells requires h5py, which is not installed"
        ) from e


def list_variables(path: str) -> List[str]:
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        out = []
        for k, v in f.items():
            if hasattr(v, "shape") and len(getattr(v, "shape", ())) == 4:
                out.append(k)
        return out


def convert(path: str, var: str, out_base: str) -> Tuple[int, int]:
    """Returns (num_cells, max_level)."""
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        refine = np.asarray(f["refine level"]).astype(np.int64)
        node_type = np.asarray(f["node type"]).astype(np.int64)
        bnd_box = np.asarray(f["bounding box"], np.float64)  # (nb, 3, 2)
        data = np.asarray(f[var], np.float64)  # (nb, nzb, nyb, nxb)

    nb, nzb, nyb, nxb = data.shape
    len_total = bnd_box[0, :, 1] - bnd_box[0, :, 0]  # root block spans domain
    max_level = int(refine.max())
    finest = np.argmax(refine)
    len_fine = (bnd_box[finest, :, 1] - bnd_box[finest, :, 0]) / np.asarray(
        [nxb, nyb, nzb], np.float64
    )
    vox = np.round(len_total / len_fine).astype(np.int64)  # finest lattice dims

    lowers = []
    levels = []
    scalars = []
    for i in range(nb):
        if node_type[i] != 1:  # not a leaf
            continue
        level = max_level - int(refine[i])
        cw = 1 << level
        lower = np.round(
            (bnd_box[i, :, 0] - bnd_box[0, :, 0]) / len_total * vox
        ).astype(np.int64)
        z, y, x = np.meshgrid(
            np.arange(nzb), np.arange(nyb), np.arange(nxb), indexing="ij"
        )
        lo = np.stack(
            [lower[0] + x.ravel() * cw,
             lower[1] + y.ravel() * cw,
             lower[2] + z.ravel() * cw], axis=1,
        )
        lowers.append(lo)
        levels.append(np.full(lo.shape[0], level, np.int32))
        scalars.append(data[i].reshape(-1).astype(np.float32))

    if not lowers:
        raise ValueError("no leaf blocks found")
    lower = np.concatenate(lowers).astype(np.int32)
    level = np.concatenate(levels)
    scal = np.concatenate(scalars)
    formats.write_cells(out_base + ".cells", lower, level)
    formats.write_scalars(out_base + ".scalars", scal)
    print(
        f"#exa: flash2cells wrote {lower.shape[0]} cells "
        f"(max level {max_level}) to {out_base}.cells/.scalars"
    )
    return lower.shape[0], max_level


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path = None
    var = None
    out = "flash"
    list_mode = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--list":
            list_mode = True
            i += 1
        elif a == "--var":
            var = argv[i + 1]
            i += 2
        elif a == "-o":
            out = argv[i + 1]
            i += 2
        else:
            path = a
            i += 1
    if path is None:
        print("usage: exa-flash2cells <file.h5> [--list] [--var NAME] [-o out]")
        return 1
    if list_mode:
        for v in list_variables(path):
            print(v)
        return 0
    if var is None:
        print("need --var (use --list to see variables)")
        return 1
    convert(path, var, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

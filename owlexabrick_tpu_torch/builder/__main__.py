"""exaBuilder CLI: .cells -> .bricks [+ .kd] (the port of
``owlexabrick_tpu/builder/__main__.py``).

    python -m owlexabrick_tpu_torch.builder <in.cells> -o <out.bricks>
        [-kd|--kd out.kd] [--spatial-median | --large-bricks]
        [--max-leaf-width N] [-v] [--python]

Mirrors builder/builder.cpp:836-875.  Bricks with the native core
(``native/exabrick_native.cpp``, built with g++ at first use; a failed
build raises); ``--python`` asks for the numpy builder.  Both give the
same bricks and kd-tree, so the files are the JAX package's byte for
byte.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..io import formats
from .bricker import (
    SAH_ALIKE,
    SMALL_BRICK_COUNT,
    SPATIAL_MEDIAN,
    build_bricks,
    kd_to_arrays,
)


def _build(lower, level, strategy, max_leaf_width, force_python):
    """(Bricks, cell_ids, kd arrays) from the native core or, with
    ``force_python``, the numpy builder."""
    if force_python:
        from ..pipeline import bricks_from_build

        result = build_bricks(lower, level, strategy, max_leaf_width)
        bricks, cell_ids = bricks_from_build(result)
        return bricks, cell_ids, kd_to_arrays(result.kd)
    from ..native import native_build_bricks_flat

    return native_build_bricks_flat(lower, level, strategy, max_leaf_width,
                                    with_kd=True)


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    in_file = None
    out_file = None
    kd_file = None
    strategy = SAH_ALIKE
    max_leaf_width = 127
    verbose = False
    force_python = False

    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            in_file = a
            i += 1
        elif a == "-o":
            out_file = argv[i + 1]
            i += 2
        elif a in ("-kd", "--kd"):
            kd_file = argv[i + 1]
            i += 2
        elif a in ("--no-shift-planes", "--no-planes", "--spatial-median",
                   "--spatial-median-builder"):
            strategy = SPATIAL_MEDIAN
            i += 1
        elif a == "--large-bricks":
            strategy = SMALL_BRICK_COUNT
            i += 1
        elif a == "--max-leaf-width":
            max_leaf_width = int(argv[i + 1])
            i += 2
        elif a == "-v":
            verbose = True
            i += 1
        elif a == "--python":
            force_python = True
            i += 1
        elif a == "--parallel":
            i += 1  # accepted for compatibility; the native builder decides
        else:
            raise SystemExit(f"un-recognized cmdline arg '{a}'")

    if not in_file:
        raise SystemExit("no input file specified...")
    if not out_file:
        raise SystemExit("no output file specified...")

    lower, level = formats.read_cells(in_file)
    print(f"#exa: loaded {lower.shape[0]} cells, levels "
          f"{int(level.min())}..{int(level.max())}")

    t0 = time.time()
    bricks, cell_ids, kd = _build(lower, level, strategy, max_leaf_width,
                                  force_python)
    dt = time.time() - t0

    sizes = bricks.size
    print(f"#exa: done bricking in {dt:.2f}s, created "
          f"{bricks.num_bricks} bricks")
    print(f"#exa: average num cells per brick: "
          f"{sizes.mean(axis=0).tolist()}")
    print(f"#exa: number of single-cell bricks: "
          f"{int((sizes == 1).all(axis=1).sum())}")
    if verbose:
        print(f"#exa: builder {'numpy' if force_python else 'native'}, "
              f"strategy {strategy}, max leaf width {max_leaf_width}")

    ends = bricks.begin.astype(np.int64) + np.prod(
        sizes.astype(np.int64), axis=1)
    formats.write_bricks(
        out_file, lower=bricks.lower, size=sizes, level=bricks.level,
        cell_ids_per_brick=[cell_ids[b:e] for b, e in
                            zip(bricks.begin.astype(np.int64), ends)],
    )
    print(f"#exa: wrote {out_file}")

    if kd_file:
        formats.write_kd(kd_file, formats.pack_kd_nodes(*kd))
        print(f"#exa: wrote {kd_file} ({len(kd[0])} nodes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

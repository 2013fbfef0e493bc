"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``owlexabrick_tpu_torch``, on a
machine with as many CUDA cards as the cell asks for.  Prints one JSON
object as the last line of standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
``first_run_build_s`` (what this run built because the checkout had not:
the kernels' library, a configuration's cells file), and ``checks``
last: each compared number with its limit), and the
compared numbers as the last lines of standard error.  Exits non-zero
and prints no result without the cards, or if JAX or the JAX package was
loaded.

Spawned worker processes import this file as their main module, so it
does nothing at import.
"""

import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    os.environ["USE_FLAX"] = "0"

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(root))
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload, root / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("portbench: no CUDA card available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}, which no run may load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

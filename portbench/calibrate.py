"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --frames 8 [--control-seeds 1,2,3]

In one process (set-up is long): for each seed, the program renders
``--frames`` frames of the cell's traffic from that seed's start, the
frames the run's rule picks (``harness.sample_frames``) are rendered by
the plain reference, and the compared numbers are printed (the lower
readings).  For each control seed, the reference computed in bfloat16
(the precision below the configuration's float32) takes the program's
place on the same picks (the upper readings).  One JSON line per seed
and side; the benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse
    import json
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(root))
    from portbench import harness

    cell = harness.load_cell(args.workload, root / "BENCHMARK.json")
    readings(cell, [int(s) for s in args.seeds.split(",")],
             [int(s) for s in args.control_seeds.split(",") if s],
             args.frames, args.device,
             lambda rec: print(json.dumps(rec), flush=True))
    return 0


def readings(cell, seeds, control_seeds, frames, device, emit):
    """Emit {side, seed, frames, numbers} per seed: side "program" for
    ``seeds``, "control" for ``control_seeds``."""
    from portbench import harness

    sess = harness.Session(cell, seeds[0], device)
    sess.warm_up()
    ref = sess.reference()
    low = None
    chk = cell.params["check"]
    start = int(cell.traffic.get("warmup", {}).get("frames", 1))
    for side, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            sess.reseed(seed)
            run = harness.Run(seconds=0.0)
            for k in range(start, start + frames):
                t = time.perf_counter()
                out = sess.frame(k)
                run.frame_s.append(time.perf_counter() - t)
                run.outputs.append(out)
            picks = harness.sample_frames(run, seed, int(chk["frames"]),
                                          bool(chk.get("slowest", False)))
            if side == "control":
                if low is None:
                    low = sess.reference(bf16=True)
                outs = [(run.outputs[i][0], low.frame_words(
                    sess.reference_state(run.outputs[i][0])))
                    for i in picks]
                rows, _ = harness.check(sess, outs, range(len(outs)),
                                        device, reference=ref)
            else:
                rows, _ = harness.check(sess, run.outputs, picks, device,
                                        reference=ref)
            emit(dict(side=side, seed=seed, at_s=round(
                time.perf_counter() - T_START, 1), frame_ms=[
                round(1e3 * s, 3) for s in run.frame_s],
                checked=[dict(frame=i, **r) for i, r in rows]))
    sess.close()


if __name__ == "__main__":
    raise SystemExit(main())

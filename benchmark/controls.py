"""The control of a cell's ``correct``: the reference put in the port's
place, computed one precision step below the configuration's (TF32 for the
models' true f32, bfloat16 for the transforms' f32), and held against the
reference by the cell's own comparison. It has to come out not correct:
its readings are the upper ends the cell's limits were set below.

    python3 benchmark/controls.py --workload CELL --seeds 1 2 3 --done N

``--done``: the cells (or calls) a window completes, among which the
compared ones are drawn from each seed, as a run draws them. Prints a JSON
line a seed with each compared number."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell, spec  # noqa: E402


def control(r: cell.Run, done: int):
    """The control's ``Checks``, made by the cell's traffic kind."""
    return spec.kind(r.traffic["kind"]).control(r, done)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--done", type=int, required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        r = cell.make_run(args.workload, seed, 0.0, False, t)
        checks = control(r, args.done)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": checks.correct, "checks": checks.as_json(),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

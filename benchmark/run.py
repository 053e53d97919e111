"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name through ``BENCHMARK.json``. The last
line of standard output is the result (JSON); the last lines of standard
error are the numbers that decided ``correct``, each beside its limit.
Exits 2 without the cell's CUDA devices and 3 if the run loaded JAX or the
JAX package; neither prints a result."""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the harness, then the checkout's port

from harness import cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        r = cell.make_run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
        result, lines = cell.run_cell(r)
    except cell.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except cell.Forbidden as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

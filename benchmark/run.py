"""Run one cell of the benchmark once, on the card, and print its result
as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics with the device's busy time and a breakdown.  The
numbers the check compares are printed, each beside its limit, as the last
lines of standard error and under ``check`` in the result.

``--calibrate N`` runs no window: for N seeds from ``--seed`` it prints the
check's readings of the program on every request of the pool, and for the
first three seeds those of the plain reference in the configuration's
control precision and in bfloat16, in the program's place.  The limits in
``configs/<config>.json`` are set from these readings.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernel caches PyTorch or Triton might keep stay inside the checkout
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.makedirs(os.environ[var], exist_ok=True)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0, metavar="N")
    ap.add_argument("--control", default=None,
                    help="put the plain reference in this precision "
                         "(tf32, bf16) in the program's place")
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.load_benchmark()
    seconds = args.seconds if args.seconds is not None else bench["run_seconds"]
    try:
        if args.calibrate:
            from benchmark import calibrate
            calibrate.run(bench, args.workload, args.seed, args.calibrate)
            return 0
        result = harness.run_cell(bench, args.workload, args.seed, seconds,
                                  bool(args.trace), T_START,
                                  control=args.control,
                                  log=lambda s: print(s, file=sys.stderr))
    except harness.ChipMissing as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"error: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

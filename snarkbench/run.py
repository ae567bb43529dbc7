"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m snarkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Inputs are made from the seed (their seconds kept out of setup_s), the
worker is brought up, the cell's traffic drives it for `--seconds`, and
with `--trace 1` a profiled stretch follows. The reference then judges
every answer. The last line of standard output is the JSON result; the
numbers compared, each with its limit, are the last lines of standard
error. Without a card, or with fewer cards than the cell asks for, the
run exits 2 and prints no result; on any fault, or if the run loaded JAX
or the JAX package, it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m snarkbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness

    try:
        run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except (KeyError, OSError, ValueError) as exc:
        print(f"[snarkbench] {exc}", file=sys.stderr)
        return 1
    run.part("benchmark_import")
    import torch

    run.part("torch_import")
    want = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"[snarkbench] the cell needs {want} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run.part("card_check")
    try:
        result = harness.execute(run)
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"[snarkbench] the run loaded {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"[snarkbench] check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

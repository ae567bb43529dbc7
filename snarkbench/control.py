"""The control of a cell's checks, run on the card at the cell's own size:

    python3 -m snarkbench.control --workload <cell> --seeds 11,12,13 --seconds 8 \
        --mode truncated [--mode deterministic] [--mode none]

For each mode and seed, one run of the cell in this process (inputs, set-up,
a window of `--seconds`, the reference's judgement) with the fault of
`faults.py` planted under the program; `none` plants nothing and reads the
sound program. One JSON line a run: the mode, the seed and the numbers
compared, each with its limit. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m snarkbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--mode", action="append", required=True)
    args = ap.parse_args(argv)
    from . import faults, harness

    import torch

    if not torch.cuda.is_available():
        print("[snarkbench] the control runs on a CUDA card", file=sys.stderr)
        return 2
    for mode in args.mode:
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.Run(args.workload, seed, args.seconds, False)
            ctx = contextlib.nullcontext() if mode == "none" else faults.planted(mode)
            with ctx:
                result = harness.execute(run)
            print(json.dumps({"mode": mode, "seed": seed, "correct": result["correct"],
                              "attempted": result["attempted"], "failed": result["failed"],
                              "metrics": result["metrics"], "checks": result["checks"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

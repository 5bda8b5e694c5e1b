#!/usr/bin/env python3
"""The control of an LM decode cell's check, on the card at the cell's
own size: the plain reference computed in TF32 in the program's place
(``zamba2_runner.control_reading``), judged by the run's own check at the
positions a run of ``--seconds`` compares.  Each seed prints its checks
beside their limits on standard error and one JSON line with
``correct``, which has to be false; the smallest ``logit_err`` is the
check's upper reading (``bench/configs/<config>.json``
``logit_err_limit`` lies below).  Exits 1 if any seed's control passes.

    python3 bench/lm_control.py --workload zamba2i-decode-8x3584 \\
        --seeds 5,6,7
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    from bench.harness.cells import load_cell
    from bench.harness.zamba2_runner import control_reading
    cell = load_cell(args.workload)
    passed = 0
    for s in (int(x) for x in args.seeds.split(",")):
        r = control_reading(cell, s, args.seconds, torch.device("cuda:0"))
        for name, c in r["checks"].items():
            print(f"seed {s} check {name} {c['value']!r} limit "
                  f"{c['limit']!r}", file=sys.stderr, flush=True)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
        passed += r["correct"]
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())

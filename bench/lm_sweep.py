#!/usr/bin/env python3
"""Find an LM decode cell's knee: the largest ``step_rate`` at which the
token latency's p95 stays within 1 s, no request fails, and the backlog
does not grow over the window (at most the one step in flight is left
at the window's end, and the median step latency of the window's last
third is within 1.5x its first third's, or within 50 ms of it).  The
knee is the largest rate that held at it and at every smaller rate
tried; the cell's rate is 4/5 of it.

    python3 bench/lm_sweep.py --workload zamba2i-decode-8x3584 \\
        --rates 6,7,8,9 --seconds 20 --seed 11

One ``zamba2_runner.run`` a rate in this process (set-up, window, check),
each with its own seed (``--seed`` plus the rate's index).  Prints a row
a rate, its ``logit_err`` beside it, and last one JSON line with the
rows, the knee and 4/5 of it."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLO_MS = 1000.0
GROWTH, GROWTH_MS = 1.5, 50.0


def held(row) -> bool:
    first, last = row["p50_first_third_ms"], row["p50_last_third_ms"]
    return (row["correct"] and row["failed"] == 0
            and row["token_p95_ms"] <= SLO_MS and row["backlog_end"] <= 1
            and last <= max(GROWTH * first, first + GROWTH_MS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated step rates, in steps/s")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    from bench.harness import zamba2_runner
    from bench.harness.cells import load_cell
    dev = torch.device("cuda:0")
    rows = []
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        cell = load_cell(args.workload)
        cell.traffic = dict(cell.traffic, step_rate=rate)
        out = zamba2_runner.run(cell, args.seed + i, args.seconds, False, dev,
                            time.monotonic())
        ld = out["load"]
        row = {"step_rate": rate, "seed": args.seed + i,
               "correct": out["correct"], "attempted": out["attempted"],
               "failed": out["failed"],
               "token_p50_ms": ld["token_p50_ms"],
               "token_p95_ms": ld["token_p95_ms"],
               "p50_first_third_ms": ld["p50_first_third_ms"],
               "p50_last_third_ms": ld["p50_last_third_ms"],
               "backlog_end": ld["backlog_end"],
               "late_p95_ms": ld["late_p95_ms"],
               "logit_err": out["checks"]["logit_err"]["value"],
               "memory_peak_bytes": out["memory_peak_bytes"]}
        row["held"] = held(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = None
    for r in sorted(rows, key=lambda r: r["step_rate"]):
        if not r["held"]:
            break
        knee = r["step_rate"]
    print(json.dumps({"workload": args.workload, "rows": rows, "knee": knee,
                      "cell_step_rate": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Find a cell's knee: the largest census (beds) at which
``score_p95_ms`` stays within the server's 1-s SLO, no query fails, and
the backlog does not grow over the window: the median latency of the
window's last third stays within 1.5x its first third's, or within
50 ms of it.  The knee is the largest census that held in every run at
it and at every smaller census tried.

    python3 bench/sweep.py --workload zoo60-steady --beds 64,96,128 \\
        --seconds 30 --seed 11

One ``bench/run.py --beds N`` process a census, in turn, each with its
own seed (``--seed`` plus the census).  Prints a row a census and, last,
one JSON line with the rows, the knee and 4/5 of it rounded down."""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLO_MS = 1000.0
GROWTH, GROWTH_MS = 1.5, 50.0


def held(row) -> bool:
    first, last = row["p50_first_third_ms"], row["p50_last_third_ms"]
    return (row["correct"] and row["failed"] == 0
            and row["score_p95_ms"] <= SLO_MS
            and last <= max(GROWTH * first, first + GROWTH_MS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--beds", required=True,
                    help="comma-separated censuses, in beds")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    rows = []
    for u in (int(x) for x in args.beds.split(",")):
        p = subprocess.run(
            [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
             args.workload, "--seed", str(args.seed + u), "--seconds",
             str(args.seconds), "--trace", "0", "--beds", str(u)],
            cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        if p.returncode or not lines:
            print(f"beds {u}: exit {p.returncode}\n{p.stderr[-3000:]}",
                  flush=True)
            break
        r = json.loads(lines[-1])
        ld = r["load"]
        row = {"beds": u, "correct": r["correct"],
               "attempted": r["attempted"], "failed": r["failed"],
               "score_p50_ms": ld["score_p50_ms"],
               "score_p95_ms": ld["score_p95_ms"],
               "p50_first_third_ms": ld["p50_first_third_ms"],
               "p50_last_third_ms": ld["p50_last_third_ms"],
               "backlog_start": ld["backlog_start"],
               "backlog_end": ld["backlog_end"],
               "late_p95_ms": ld["late_p95_ms"], "setup_s": ld["setup_s"]}
        row["held"] = held(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not row["held"] and row["score_p95_ms"] > 3 * SLO_MS:
            break
    knee = None
    for r in sorted(rows, key=lambda r: r["beds"]):
        if not r["held"]:
            break
        knee = r["beds"]
    print(json.dumps({"workload": args.workload, "rows": rows, "knee": knee,
                      "cell_beds": None if knee is None
                      else (4 * knee) // 5}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the port (``repro_torch``).

    python3 bench/run.py --workload zoo60-steady --seed 7 --seconds 30 --trace 0

from the root of a checkout on a machine with an NVIDIA card.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: every number the
check compared, beside its limit (also the last lines of standard
error).  The cell's configuration names the runner module that does the
run (the runner contract, ``bench/harness/cells.py``); this file holds
nothing of any one runner.  Without a card, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.  ``--beds``
overrides the mix's census (the knee sweep, ``bench/sweep.py``)."""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result_of(out: Dict, kind: str, chips: int, trace: bool) -> Dict:
    """The result line from a runner's fields alone."""
    result = {
        "correct": out["correct"], "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in out["metrics"].items()},
        "device": {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace and "busy_s" in out:
        result["device"]["busy_s"] = out["busy_s"]
        result["device"]["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["load"] = out["load"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--beds", type=int, default=None)
    args = ap.parse_args(argv)
    # every cache a run may write lives at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from bench.harness.cells import load_cell, load_runner
    cell = load_cell(args.workload)
    runner = load_runner(cell)
    chips = cell.chips
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA card(s): cuda available "
             f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
             "card(s); no result")
        return 2
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(dev)
    _log(f"card: {kind}; nvidia-smi: {_power_limit()}; torch "
         f"{torch.__version__} cuda {torch.version.cuda}")
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                     T_START, beds=args.beds)
    found = forbidden_modules()
    if found:
        _log(f"modules of JAX or the JAX package are loaded: {found}; "
             "no result")
        return 3
    result = result_of(out, kind, chips, bool(args.trace))
    for line in runner.describe(out):
        _log(line)
    for name, c in out["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ensemble composition deep-dive: HOLMES vs all baselines (Table 2) with
the search trajectory (Fig. 6) and the accuracy-constrained dual (A.6)
(the port of ``examples/compose_ensemble.py``).  The zoo is restored
(or trained) and its member costs measured on the card unless
``--device cpu``; the composition itself is numpy on the host.

    python -m repro_torch.examples.compose_ensemble
    PYTHONPATH=src python -m repro_torch.examples.compose_ensemble \\
        --device cpu

``main`` returns the Table 2 rows, the Fig. 6 trajectories and the A.6
result it prints.
"""
import argparse

import numpy as np

from repro_torch.benchmarks.composition import bench_fig6, bench_table2
from repro_torch.benchmarks.zoo_setup import (build_zoo, make_profilers,
                                              single_model_stats)
from repro_torch.core.composer import ComposerParams, compose
from repro_torch.core.objective import AccuracyConstrainedObjective
from repro_torch.core.profiles import SystemConfig
from repro_torch.device import resolve_device


def accuracy_constrained_demo(zoo, extras):
    """A.6: min latency s.t. accuracy >= floor, same search machinery."""
    sysconf = SystemConfig(n_devices=2, n_patients=64)
    f_a, f_l = make_profilers(zoo, sysconf, extras)
    acc1, _ = single_model_stats(zoo, f_a, f_l)
    floor = float(np.quantile(acc1, 0.75))
    obj = AccuracyConstrainedObjective(floor)

    # reuse compose() by flipping the roles: maximize -latency with a
    # pseudo-"budget" on negative accuracy
    res = compose(len(zoo),
                  f_a=lambda b: -f_l(b),          # maximize -> min latency
                  f_l=lambda b: -f_a(b),          # constraint -> acc floor
                  latency_budget=-floor,
                  params=ComposerParams(N=8, K=6, seed=0))
    value = obj(-res.latency, -res.accuracy)
    print(f"\nA.6 dual: accuracy floor {floor:.4f} -> "
          f"latency {-res.accuracy * 1000:.1f} ms at "
          f"accuracy {-res.latency:.4f} "
          f"(objective value {value:.4f})")
    return {"floor": floor, "latency_s": -res.accuracy,
            "accuracy": -res.latency, "objective": value,
            "selector": np.flatnonzero(res.b_star).tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)         # raises before any build
    zoo, extras = build_zoo(n_patients=16, clips=8, steps=120, device=dev)
    table = bench_table2(seeds=(0, 1), zoo=zoo, extras=extras)
    fig6 = bench_fig6(zoo=zoo, extras=extras)
    dual = accuracy_constrained_demo(zoo, extras)
    return {"table2": table, "fig6": fig6, "dual": dual}


if __name__ == "__main__":
    main()

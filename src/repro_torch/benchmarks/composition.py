"""Table 2 / Fig. 6: the ensemble composition comparisons (the port of
``benchmarks/composition.py``'s ``run_all_methods``, ``bench_table2``
and ``bench_fig6``; Figs. 7 and 8 wait for the port's benchmark).

  * table2: RD / AF / LF / NPO / HOLMES under a fixed latency budget,
    mean +/- std over seeds, all four metrics.
  * fig6: search trajectory (accuracy & latency per iteration).

They print and return; they write no file.  Everything here is numpy
on the host; ``build_zoo`` (called when no zoo is given) scores and
measures on the card (pass a zoo built with ``device="cpu"`` to run
on the CPU).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.benchmarks.zoo_setup import (binding_budget, build_zoo,
                                              make_profilers,
                                              single_model_stats)
from repro_torch.core.bagging import all_metrics
from repro_torch.core.baselines import (accuracy_first, latency_first, npo,
                                        random_baseline)
from repro_torch.core.composer import ComposerParams, compose
from repro_torch.core.profiles import SystemConfig


def _ensemble_metrics(zoo, extras, b) -> Dict[str, float]:
    side = [extras["vitals_scores"], extras["labs_scores"]]
    sel = list(zoo.val_scores[np.asarray(b, bool)]) + side
    return all_metrics(zoo.val_labels, np.mean(sel, axis=0))


def run_all_methods(zoo, extras, budget: float, seed: int,
                    sysconf: SystemConfig, n_iters: int = 10, K: int = 6):
    f_a, f_l = make_profilers(zoo, sysconf, extras)
    acc1, lat1 = single_model_stats(zoo, f_a, f_l)
    n = len(zoo)
    rd = random_baseline(n, f_a, f_l, budget, seed=seed)
    af = accuracy_first(n, f_a, f_l, budget, acc1)
    lf = latency_first(n, f_a, f_l, budget, lat1)
    warm = [r.b_star for r in (rd, af, lf)]
    calls = n_iters * K + 12
    nr = npo(n, f_a, f_l, budget,
             max_subset=max(1, int(lf.b_star.sum())),
             n_calls=calls, seed=seed, warm_start=warm)
    hb = compose(n, f_a, f_l, budget,
                 ComposerParams(N=n_iters, K=K, N0=12, seed=seed),
                 warm_start=warm)
    return {"RD": rd, "AF": af, "LF": lf, "NPO": nr, "HOLMES": hb}


def bench_table2(budget: float = None, seeds=(0, 1, 2), verbose=True,
                 zoo=None, extras=None) -> Dict:
    if zoo is None:
        zoo, extras = build_zoo(verbose=verbose)
    sysconf = SystemConfig(n_devices=2, n_patients=64)
    if budget is None:
        _, f_l = make_profilers(zoo, sysconf, extras)
        budget = binding_budget(zoo, f_l)
    t0 = time.time()
    per_method: Dict[str, List[Dict[str, float]]] = {}
    for seed in seeds:
        res = run_all_methods(zoo, extras, budget, seed, sysconf)
        for name, r in res.items():
            m = _ensemble_metrics(zoo, extras, r.b_star)
            m["latency"] = r.latency
            m["feasible"] = float(r.feasible)
            per_method.setdefault(name, []).append(m)
    table = {}
    for name, rows in per_method.items():
        table[name] = {k: (float(np.mean([r[k] for r in rows])),
                           float(np.std([r[k] for r in rows])))
                       for k in rows[0]}
    if verbose:
        print(f"\nTable 2 (budget {budget * 1000:.0f} ms, "
              f"{len(seeds)} seeds, {time.time() - t0:.0f}s):")
        print(f"{'method':8s} {'ROC-AUC':>16s} {'PR-AUC':>16s} "
              f"{'F1':>16s} {'Accuracy':>16s} {'latency':>10s}")
        for name in ("RD", "AF", "LF", "NPO", "HOLMES"):
            r = table[name]
            print(f"{name:8s} "
                  f"{r['roc_auc'][0]:.4f}±{r['roc_auc'][1]:.4f} "
                  f"{r['pr_auc'][0]:.4f}±{r['pr_auc'][1]:.4f} "
                  f"{r['f1'][0]:.4f}±{r['f1'][1]:.4f} "
                  f"{r['accuracy'][0]:.4f}±{r['accuracy'][1]:.4f} "
                  f"{r['latency'][0] * 1000:9.1f}ms")
    return table


def bench_fig6(budget: float = None, seed: int = 0, verbose=True,
               zoo=None, extras=None) -> Dict:
    if zoo is None:
        zoo, extras = build_zoo(verbose=verbose)
    sysconf = SystemConfig(n_devices=2, n_patients=64)
    if budget is None:
        _, f_l = make_profilers(zoo, sysconf, extras)
        budget = binding_budget(zoo, f_l)
    res = run_all_methods(zoo, extras, budget, seed, sysconf, n_iters=12)
    out = {}
    for name, r in res.items():
        out[name] = [{"calls": h["profiler_calls"],
                      "acc": h["new_acc"], "lat": h["new_lat"],
                      "best_acc": h.get("best_acc")}
                     for h in r.history]
    if verbose:
        print("\nFig 6 trajectory (best feasible AUC by profiler calls):")
        for name in ("NPO", "HOLMES"):
            tr = out[name]
            line = " ".join(f"{h['best_acc']:.3f}" if h["best_acc"] ==
                            h["best_acc"] else "  -  "
                            for h in tr[:: max(1, len(tr) // 8)])
            print(f"  {name:7s} {line}")
    return out

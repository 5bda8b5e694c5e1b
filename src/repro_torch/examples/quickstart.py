"""Quickstart: the full HOLMES loop in miniature (the port of
``examples/quickstart.py``), on the card unless ``--device cpu``.

1. Generate a synthetic ICU cohort and restore (or train) a small ECG
   model zoo.
2. Profile accuracy (true bagging on validation) + latency (network
   calculus over per-member costs measured on the device).
3. Compose the ensemble with HOLMES (Algorithm 1) under a latency budget.
4. Deploy the chosen ensemble in the streaming pipeline and serve a few
   observation windows end-to-end.

    python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``main`` returns what it prints: the composition and every served
record.
"""
import argparse

import numpy as np

from repro_torch.benchmarks.zoo_setup import (binding_budget, build_zoo,
                                              make_profilers)
from repro_torch.core.composer import ComposerParams, compose
from repro_torch.core.profiles import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.serving.pipeline import (EnsembleService, StreamingPipeline,
                                          ZooMember)
from repro_torch.training.data import ecg_clip, sample_patient, vitals_clip


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)         # raises before any build

    print("== 1. train the model zoo (cached after first run) ==")
    zoo, extras = build_zoo(n_patients=16, clips=8, steps=120, device=dev)

    print("\n== 2+3. compose the ensemble under a latency budget ==")
    sysconf = SystemConfig(n_devices=2, n_patients=8)
    f_a, f_l = make_profilers(zoo, sysconf, extras)
    budget = binding_budget(zoo, f_l)
    res = compose(len(zoo), f_a, f_l, budget,
                  ComposerParams(N=8, K=6, N0=10, seed=0))
    chosen = [zoo.profiles[i].name for i in np.flatnonzero(res.b_star)]
    print(f"budget {budget * 1000:.1f} ms -> ensemble {chosen}")
    print(f"val ROC-AUC {res.accuracy:.4f} @ latency "
          f"{res.latency * 1000:.1f} ms ({res.n_profiler_calls} "
          f"profiler calls)")

    print("\n== 4. serve it on a live stream ==")
    members = [ZooMember(extras["specs"][i],
                         extras["params"][zoo.profiles[i].name])
               for i in np.flatnonzero(res.b_star)]
    svc = EnsembleService(members, vitals_model=extras["vitals_model"],
                          labs_model=extras["labs_model"], device=dev)
    svc.warmup()
    print(f"fused dispatch plan: {len(members)} members -> "
          f"{svc.n_buckets} stacked buckets per query")
    pipe = StreamingPipeline(svc, n_patients=2, window_seconds=3.0,
                             device=dev)
    rng = np.random.default_rng(0)
    records = []
    for patient in range(2):
        pp = sample_patient(rng, patient % 2)
        t = 0.0
        for _ in range(3):                    # three 3-second windows
            ecg = ecg_clip(rng, pp, seconds=3)
            vit = vitals_clip(rng, pp, seconds=3)
            pipe.feed(t, patient, "vitals", vit)
            rec = pipe.feed(t + 3.0, patient, "ecg", ecg)
            t += 3.0
            if rec:
                records.append(rec)
                print(f"  patient {patient} t={t:5.1f}s "
                      f"P(stable)={rec.score:.3f} "
                      f"latency={rec.latency * 1000:.1f} ms")
    lats = pipe.latencies()
    p95 = float(np.percentile(lats, 95)) if len(lats) else None
    if len(lats):
        print(f"served {len(lats)} queries, p95 latency "
              f"{p95 * 1000:.1f} ms")
    return {"chosen": chosen, "budget_s": budget,
            "accuracy": res.accuracy, "latency_s": res.latency,
            "n_buckets": svc.n_buckets, "records": records,
            "p95_s": p95}


if __name__ == "__main__":
    main()

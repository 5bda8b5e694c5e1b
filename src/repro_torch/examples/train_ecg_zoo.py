"""Train the paper's model zoo (§4.1.1) end to end: per-lead 1-D-stripe
ResNeXt classifiers across the width x depth grid, plus the vitals random
forest and labs logistic regression (the port of
``examples/train_ecg_zoo.py``).  A few hundred optimizer steps per model
on the synthetic cohort, on the card unless ``--device cpu``.

    python -m repro_torch.examples.train_ecg_zoo [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_ecg_zoo \\
        --device cpu

Members come from the port's cache (``results/zoo_cache_torch/``), then
from the reference's committed one (read only), and are trained only
when neither has them (``benchmarks.zoo_setup.build_zoo``).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--patients", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks.zoo_setup import build_zoo
    zoo, extras = build_zoo(n_patients=args.patients, clips=8,
                            steps=args.steps, device=args.device)
    print("\nmodel zoo profiles (Table 3):")
    print(f"{'name':16s} {'depth':>5s} {'width':>5s} {'MACs':>10s} "
          f"{'mem(KB)':>8s} {'val AUC':>8s}")
    for p in zoo.profiles:
        print(f"{p.name:16s} {p.depth:5d} {p.width:5d} {p.macs:10.2e} "
              f"{p.memory_bytes / 1024:8.1f} {p.val_auc:8.4f}")
    aucs = [p.val_auc for p in zoo.profiles]
    print(f"\nzoo AUC range: {min(aucs):.3f} .. {max(aucs):.3f} "
          f"(spread is what the composer exploits)")


if __name__ == "__main__":
    main()

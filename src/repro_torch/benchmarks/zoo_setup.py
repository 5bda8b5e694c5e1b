"""Shared benchmark substrate (the port of ``benchmarks/zoo_setup.py``):
trains the ECG model zoo on the synthetic ICU cohort, caches trained
params, validation scores and serving costs, and exposes the accuracy
and latency profilers every benchmark uses.

Where a member's params come from, in order:

1. the port's own cache (``results/zoo_cache_torch/`` by default, or
   ``cache=``), which only the port writes;
2. the reference's committed cache, ``results/zoo_cache/``, read and
   never written: the same file format and names, so the members the
   JAX package trained restore here unchanged;
3. otherwise ``train_ecg_model`` on ``device``, saved to the port's
   cache.

Measured serving costs are always the port's own, measured on the
device the zoo is built on and cached per device type
(``costs_{tag}_{cuda|cpu}.json``); the reference's costs file is a
measurement of another program and is never read.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.core.bagging import roc_auc
from repro_torch.core.profiles import ModelProfile, ModelZoo, SystemConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.ecg_resnext import (ecg_macs, ecg_param_count,
                                            init_ecg)
from repro_torch.models.tabular import LogisticRegression, VitalsForest
from repro_torch.serving.latency import LatencyProfiler
from repro_torch.serving.pipeline import EnsembleService, ZooMember
from repro_torch.training import checkpoint
from repro_torch.training.data import make_icu_dataset, split_by_patient
from repro_torch.training.train_loop import (ecg_predict_proba,
                                             train_ecg_model)

RESULTS = Path(__file__).resolve().parents[3] / "results"
CACHE = RESULTS / "zoo_cache_torch"      # the port's own
COMMITTED = RESULTS / "zoo_cache"        # the reference's, read only


def zoo_tag(reduced: bool, n_patients: int, clips: int, seconds: int,
            steps: int, seed: int, widths=None, blocks=None) -> str:
    """The reference's cache tag for these build parameters."""
    return (f"r{int(reduced)}_p{n_patients}_c{clips}_s{seconds}_t{steps}"
            f"_seed{seed}"
            + ("w" + "-".join(map(str, widths)) if widths else "")
            + ("b" + "-".join(map(str, blocks)) if blocks else ""))


def build_zoo(reduced: bool = True, n_patients: int = 32,
              clips: int = 12, seconds: int = 3, steps: int = 160,
              seed: int = 0, verbose: bool = True, widths=None,
              blocks=None, cache: Optional[os.PathLike] = None,
              device: DeviceLike = None) -> Tuple[ModelZoo, Dict]:
    """Returns (zoo with cached val scores, extras dict).  Trains,
    scores and measures on ``device`` (default ``cuda:0``).
    ``extras["trained"]`` holds the training seconds of each member
    this call trained (empty when every member was restored)."""
    dev = resolve_device(device)
    cache = Path(cache) if cache is not None else CACHE
    cache.mkdir(parents=True, exist_ok=True)
    tag = zoo_tag(reduced, n_patients, clips, seconds, steps, seed,
                  widths, blocks)

    data = make_icu_dataset(n_patients, clips, seed=seed, seconds=seconds)
    train, val = split_by_patient(data, holdout=max(4, n_patients // 3))
    specs = zoo_specs(reduced=reduced, input_len=seconds * 250,
                      widths=widths, blocks=blocks)

    profiles: List[ModelProfile] = []
    scores: List[np.ndarray] = []
    params_all, trained = {}, {}
    t0 = time.time()
    for i, spec in enumerate(specs):
        name = f"{tag}_{spec.name}.npz"
        ck, committed = cache / name, COMMITTED / name
        if ck.exists() or committed.exists():
            template = init_ecg(spec, torch.Generator().manual_seed(seed + i),
                                dev)
            params = checkpoint.restore(
                str(ck if ck.exists() else committed), template)
        else:
            t1 = time.perf_counter()
            params, _ = train_ecg_model(spec, train["ecg"][:, spec.lead, :],
                                        train["label"], steps=steps,
                                        seed=seed + i, device=dev)
            trained[spec.name] = time.perf_counter() - t1
            checkpoint.save(str(ck), params, {"spec": spec.name})
        sc = ecg_predict_proba(params, val["ecg"][:, spec.lead, :], spec)
        auc = roc_auc(val["label"] == 1, sc)
        profiles.append(ModelProfile(
            name=spec.name, depth=spec.blocks, width=spec.width,
            macs=ecg_macs(spec), memory_bytes=4.0 * ecg_param_count(params),
            modality=spec.lead, input_len=spec.input_len, val_auc=auc))
        scores.append(sc)
        params_all[spec.name] = params
        if verbose:
            print(f"[zoo] {spec.name}: val AUC {auc:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    # CPU-side models (join the accuracy ensemble, not the latency zoo)
    vit = VitalsForest(n_channels=7, n_trees=15, seed=seed)
    vit.fit(train["vitals"], train["label"].astype(float))
    vit_scores = vit.predict_proba(val["vitals"])
    lab = LogisticRegression(steps=300, seed=seed)
    lab.fit(train["labs"], train["label"].astype(float))
    lab_scores = lab.predict_proba(val["labs"])

    zoo = ModelZoo(profiles, val_scores=np.stack(scores),
                   val_labels=(val["label"] == 1).astype(int))

    # measured per-member serving cost on this device (closed-loop, the
    # paper's mu measurement), cached alongside the zoo
    costs_path = cache / f"costs_{tag}_{dev.type}.json"
    if costs_path.exists():
        measured = json.loads(costs_path.read_text())
    else:
        svc = EnsembleService([ZooMember(s, params_all[s.name])
                               for s in specs], device=dev)
        cs = svc.measured_costs(reps=3)
        measured = {s.name: c for s, c in zip(specs, cs)}
        costs_path.write_text(json.dumps(measured))

    extras = {"train": train, "val": val, "params": params_all,
              "specs": specs, "vitals_scores": vit_scores,
              "labs_scores": lab_scores, "vitals_model": vit,
              "labs_model": lab,
              "measured_costs": [measured[s.name] for s in specs],
              "trained": trained}
    (cache / f"zoo_{tag}.json").write_text(
        json.dumps({"aucs": [p.val_auc for p in profiles]}))
    return zoo, extras


def make_profilers(zoo: ModelZoo, sysconf: SystemConfig,
                   extras: Dict = None, include_cpu_models: bool = True,
                   measured: bool = True):
    """(f_a, f_l): the paper's two profilers.  f_a evaluates the TRUE
    bagging ensemble on the validation set (side CPU models included per
    §4.1.1); f_l is the network-calculus latency profiler, fed by the
    MEASURED closed-loop per-member costs when available (§3.4)."""
    y = zoo.val_labels
    side = []
    if include_cpu_models and extras is not None:
        side = [extras["vitals_scores"], extras["labs_scores"]]

    def f_a(b) -> float:
        sel = zoo.val_scores[np.asarray(b, bool)]
        rows = list(sel) + side
        if not rows:
            return 0.5
        return roc_auc(y, np.mean(rows, axis=0))

    cost_fn = None
    if measured and extras is not None and "measured_costs" in extras:
        costs = extras["measured_costs"]
        cost_fn = lambda i: costs[i]
    f_l = LatencyProfiler(zoo, sysconf, cost_fn=cost_fn)
    return f_a, f_l


def binding_budget(zoo: ModelZoo, f_l, frac: float = 0.6) -> float:
    """A latency budget at which selection genuinely binds: frac x the
    latency of serving the ENTIRE zoo (the paper's 200 ms plays the same
    role against its 60-model zoo on 2 V100s)."""
    full = f_l(np.ones(len(zoo), np.int8))
    return float(frac * full)


def single_model_stats(zoo: ModelZoo, f_a, f_l):
    n = len(zoo)
    eye = np.eye(n, dtype=np.int8)
    acc = np.asarray([f_a(eye[i]) for i in range(n)])
    lat = np.asarray([f_l(eye[i]) for i in range(n)])
    return acc, lat

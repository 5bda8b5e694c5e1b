"""Model profiles (paper Table 3) and the model-zoo description matrix V
(the port of ``repro/core/profiles.py``).

One profile v in R^m per zoo member: depth, width, MACs, memory, input
modality, input length, validation ROC-AUC.  The zoo is V in R^{n x m};
a model ensemble is a binary selector b in {0,1}^n.  System configuration
c in R^d carries the resource constraints the latency profiler needs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

PROFILE_FIELDS = ("depth", "width", "macs", "memory_bytes", "modality",
                  "input_len", "val_auc")


@dataclasses.dataclass
class ModelProfile:
    """Table 3: deep model description in the model zoo."""
    name: str
    depth: int                  # stacked layers / residual blocks
    width: int                  # conv filters (or d_model)
    macs: float                 # multiply-accumulates per query
    memory_bytes: float         # parameter memory
    modality: int               # ECG lead id (0..2) or modality index
    input_len: int              # samples per segment
    val_auc: float              # ROC-AUC on validation set

    def vector(self) -> np.ndarray:
        return np.asarray([self.depth, self.width, self.macs,
                           self.memory_bytes, self.modality,
                           self.input_len, self.val_auc], np.float64)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """c in R^d (§3.3.1): resources + load the latency profiler sees."""
    n_devices: int = 2
    n_patients: int = 64
    ingest_hz: float = 250.0          # per-patient query rate
    device_flops: float = 7.8e12      # per-device peak (V100 fp32-ish)
    device_mem_bytes: float = 32e9
    window_seconds: float = 30.0      # observation window Delta-T

    def vector(self) -> np.ndarray:
        return np.asarray([self.n_devices, self.n_patients, self.ingest_hz,
                           self.device_flops, self.device_mem_bytes,
                           self.window_seconds], np.float64)


class ModelZoo:
    """Container pairing profiles with (optional) cached validation scores
    so the accuracy profiler can evaluate true bagging ensembles cheaply
    (the paper's f_a re-evaluates the ensemble on the validation set; with
    per-model score vectors cached that is exact and O(n_samples))."""

    def __init__(self, profiles: Sequence[ModelProfile],
                 val_scores: Optional[np.ndarray] = None,
                 val_labels: Optional[np.ndarray] = None):
        self.profiles: List[ModelProfile] = list(profiles)
        self.val_scores = val_scores      # [n_models, n_val] P(stable)
        self.val_labels = val_labels      # [n_val]

    def __len__(self) -> int:
        return len(self.profiles)

    @property
    def V(self) -> np.ndarray:
        """Model description matrix V in R^{n x m}."""
        return np.stack([p.vector() for p in self.profiles])

    def names(self) -> List[str]:
        return [p.name for p in self.profiles]

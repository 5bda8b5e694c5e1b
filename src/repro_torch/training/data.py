"""Data pipelines (the port of ``repro/training/data.py``): numpy only,
so the same arguments and seeds give the reference's arrays bit for bit.

1. Synthetic ICU stream (the paper's data is CHOA pediatric CICU, which we
   cannot ship): class-conditional multimodal generator — 3-lead ECG-like
   waveforms at 250 Hz, 7 vitals at 1 Hz, 8 irregular labs.  "critical"
   (label 0) vs "stable" (label 1) differ in heart rate variability, noise
   level, ST-segment offset and vitals drift, so the task is learnable but
   not trivial.  Segmented into 30 s clips exactly as §4.1.1.

2. LM token pipeline for the assigned datacenter architectures (synthetic
   zipf tokens; deterministic, seedable, sharded-batch friendly).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.ecg_zoo import (CLIP_SECONDS, ECG_HZ, N_LABS,
                                         N_VITALS, VITALS_HZ)


# ====================================================== synthetic ICU data
@dataclasses.dataclass
class PatientParams:
    heart_rate: float          # bpm
    hrv: float                 # beat-to-beat jitter (s)
    noise: float               # additive noise std
    st_offset: float           # ST-segment elevation (class signal)
    vitals_base: np.ndarray    # [N_VITALS]
    vitals_drift: np.ndarray   # [N_VITALS] per-second drift
    labs: np.ndarray           # [N_LABS]


def sample_patient(rng: np.random.Generator, label: int,
                   atypicality: float = 0.0) -> PatientParams:
    """label 0 = critical, 1 = stable.  ``atypicality`` in [0, 1] blends
    the patient's physiology toward the OTHER class (atypical
    presentations), bounding achievable single-model accuracy."""
    a = float(np.clip(atypicality, 0.0, 0.9))

    def mix(crit_lo, crit_hi, stab_lo, stab_hi):
        crit_v = rng.uniform(crit_lo, crit_hi)
        stab_v = rng.uniform(stab_lo, stab_hi)
        own, other = (crit_v, stab_v) if label == 0 else (stab_v, crit_v)
        return float((1 - a) * own + a * other)

    crit_bias, stab_bias = 0.8, -0.2
    bias = (1 - a) * (crit_bias if label == 0 else stab_bias) \
        + a * (stab_bias if label == 0 else crit_bias)
    return PatientParams(
        heart_rate=mix(130, 170, 100, 130),
        hrv=mix(0.002, 0.01, 0.02, 0.05),
        noise=mix(0.08, 0.2, 0.02, 0.08),
        st_offset=mix(0.08, 0.25, -0.02, 0.05),
        vitals_base=rng.normal(0.0, 0.5, N_VITALS) + bias,
        vitals_drift=rng.normal(0.0, (1 - a) * 0.02 + a * 0.005
                                if label == 0 else
                                (1 - a) * 0.005 + a * 0.02, N_VITALS),
        labs=rng.normal((1 - a) * (0.45 if label == 0 else -0.25)
                        + a * (-0.25 if label == 0 else 0.45), 0.45,
                        N_LABS),
    )


def _ecg_beat(t: np.ndarray, st: float) -> np.ndarray:
    """Crude PQRST morphology on t in [0, 1)."""
    p = 0.15 * np.exp(-((t - 0.15) / 0.03) ** 2)
    q = -0.2 * np.exp(-((t - 0.35) / 0.012) ** 2)
    r = 1.2 * np.exp(-((t - 0.40) / 0.015) ** 2)
    s = -0.3 * np.exp(-((t - 0.45) / 0.015) ** 2)
    tw = 0.3 * np.exp(-((t - 0.65) / 0.05) ** 2)
    st_seg = st * ((t > 0.45) & (t < 0.62)).astype(float)
    return p + q + r + s + tw + st_seg


_LEAD_GAIN = np.array([1.0, 1.35, 0.75])


def ecg_clip(rng: np.random.Generator, pp: PatientParams,
             seconds: int = CLIP_SECONDS, hz: int = ECG_HZ) -> np.ndarray:
    """[3 leads, seconds*hz] waveform clip."""
    n = seconds * hz
    beat_len = 60.0 / pp.heart_rate
    t, out = 0.0, np.zeros(n)
    phase = np.zeros(n)
    ts = np.arange(n) / hz
    starts = []
    while t < seconds + beat_len:
        starts.append(t)
        t += beat_len + rng.normal(0.0, pp.hrv)
    sig = np.zeros(n)
    for s0, s1 in zip(starts[:-1], starts[1:]):
        idx = (ts >= s0) & (ts < s1)
        if idx.any():
            sig[idx] = _ecg_beat((ts[idx] - s0) / max(s1 - s0, 1e-3),
                                 pp.st_offset)
    clips = (sig[None, :] * _LEAD_GAIN[:, None]
             + rng.normal(0.0, pp.noise, (3, n)))
    return clips.astype(np.float32)


def vitals_clip(rng: np.random.Generator, pp: PatientParams,
                seconds: int = CLIP_SECONDS) -> np.ndarray:
    """[N_VITALS, seconds] 1 Hz vitals."""
    t = np.arange(seconds * VITALS_HZ)
    base = pp.vitals_base[:, None] + pp.vitals_drift[:, None] * t[None, :]
    return (base + rng.normal(0, 0.1, base.shape)).astype(np.float32)


def labs_sample(rng: np.random.Generator, pp: PatientParams) -> np.ndarray:
    return (pp.labs + rng.normal(0, 0.2, N_LABS)).astype(np.float32)


def make_icu_dataset(n_patients: int, clips_per_patient: int,
                     seed: int = 0, seconds: int = CLIP_SECONDS,
                     hz: int = ECG_HZ, ambiguity: float = 0.35
                     ) -> Dict[str, np.ndarray]:
    """Returns {ecg [n,3,L], vitals [n,7,seconds], labs [n,8],
    label [n], patient [n]} with a 50/50 class balance of patients.

    ``ambiguity``: mean per-patient atypicality (graded blend toward the
    other class's physiology) — bounds any single model's achievable
    accuracy and creates the accuracy spread the paper's model zoo
    exhibits (ensembles then genuinely help)."""
    rng = np.random.default_rng(seed)
    ecg, vit, labs, ys, pid = [], [], [], [], []
    for p in range(n_patients):
        label = p % 2
        atyp = float(rng.beta(1.2, 3.0)) * min(1.0, ambiguity * 3)
        pp = sample_patient(rng, label, atypicality=atyp)
        for _ in range(clips_per_patient):
            ecg.append(ecg_clip(rng, pp, seconds, hz))
            vit.append(vitals_clip(rng, pp, seconds))
            labs.append(labs_sample(rng, pp))
            ys.append(label)
            pid.append(p)
    return {"ecg": np.stack(ecg), "vitals": np.stack(vit),
            "labs": np.stack(labs), "label": np.asarray(ys, np.int32),
            "patient": np.asarray(pid, np.int32)}


def split_by_patient(data: Dict[str, np.ndarray], holdout: int
                     ) -> Tuple[Dict, Dict]:
    """Paper §4.1.1: split the cohort BY PATIENT (earlier patients train,
    recent patients validate)."""
    max_p = int(data["patient"].max())
    cut = max_p + 1 - holdout
    tr = data["patient"] < cut
    return ({k: v[tr] for k, v in data.items()},
            {k: v[~tr] for k, v in data.items()})


# ====================================================== LM token pipeline
def lm_batches(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
               zipf_a: float = 1.2) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM batches with zipf-ish marginals and a
    copy structure (second half echoes the first) so loss can decrease."""
    rng = np.random.default_rng(seed)
    while True:
        half = seq_len // 2 + 1
        first = (rng.zipf(zipf_a, size=(batch, half)) - 1) % vocab_size
        toks = np.concatenate([first, first[:, :seq_len - half]], axis=1)
        tokens = toks[:, :seq_len].astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
        yield {"tokens": tokens, "labels": labels}


def audio_frames(batch: int, frames: int, dim: int, seed: int = 0
                 ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (batch, frames, dim)).astype(np.float32)

"""The paper's own model zoo (§4.1.1): 1-D-stripe ResNeXt ECG classifiers.

Full zoo: 3 ECG leads × widths {8,16,32,64,128} × blocks {2,4,8,16} = 60
deep models.  Vitals get a random forest, labs a logistic regression; per
the paper those CPU models are NOT zoo members for latency purposes but DO
join the final accuracy ensemble.

``zoo_specs(reduced=True)`` is the CPU-friendly zoo used by tests and the
default benchmarks (3 leads × {8,16} filters × {2,4} blocks = 12 models,
shorter clips).

Architecture buckets (serving): members whose parameter pytrees are
structurally identical — same ``(width, blocks, input_len, cardinality,
kernel_size)``; the lead only selects which input slice a member consumes
— can be STACKED along a leading member axis and executed as ONE call
over the member axis.  ``bucket_key`` / ``bucket_zoo`` define that
grouping: the reduced zoo's 12 members collapse to 4 buckets (2 widths ×
2 block counts, the 3 leads folding into each bucket) and the full zoo's
60 to 20.  ``serving.pipeline.EnsembleService`` builds its fused
dispatch plan from these buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EcgModelSpec:
    name: str
    lead: int                 # 0,1,2  <-> leads I, II, III
    width: int                # filters in the first conv layer
    blocks: int               # residual blocks
    input_len: int            # samples per 30 s clip (250 Hz => 7500)
    cardinality: int = 8      # ResNeXt group count
    kernel_size: int = 7      # 1-D stripe kernel


FULL_WIDTHS = (8, 16, 32, 64, 128)
FULL_BLOCKS = (2, 4, 8, 16)
REDUCED_WIDTHS = (8, 16)
REDUCED_BLOCKS = (2, 4)


def zoo_specs(reduced: bool = True, input_len: int = None,
              widths=None, blocks=None) -> List[EcgModelSpec]:
    widths = widths or (REDUCED_WIDTHS if reduced else FULL_WIDTHS)
    blocks = blocks or (REDUCED_BLOCKS if reduced else FULL_BLOCKS)
    if input_len is None:
        input_len = 750 if reduced else 7500
    out = []
    for lead in range(3):
        for w in widths:
            for b in blocks:
                out.append(EcgModelSpec(
                    name=f"lead{lead + 1}_w{w}_b{b}",
                    lead=lead, width=w, blocks=b, input_len=input_len,
                    cardinality=min(8, w)))
    return out


BucketKey = Tuple[int, int, int, int, int]


def bucket_key(spec: EcgModelSpec) -> BucketKey:
    """Shape signature under which members share one stacked program.
    Everything but ``lead``/``name`` — two specs with equal keys have
    structurally identical parameter pytrees."""
    return (spec.width, spec.blocks, spec.input_len, spec.cardinality,
            spec.kernel_size)


def bucket_zoo(specs: Sequence[EcgModelSpec]
               ) -> Dict[BucketKey, List[int]]:
    """Group member indices by ``bucket_key`` (insertion-ordered, so
    bucket order is deterministic given spec order).  The serving path
    issues one stacked dispatch per bucket instead of one per member:
    12 -> 4 on the reduced zoo, 60 -> 20 on the full zoo."""
    out: Dict[BucketKey, List[int]] = {}
    for i, s in enumerate(specs):
        out.setdefault(bucket_key(s), []).append(i)
    return out


N_VITALS = 7     # 1 Hz vitals (mean BP, SpO2, ...)
N_LABS = 8       # irregular labs (pH, lactate, ...)
ECG_LEADS = 3    # leads I, II, III — the channel count of every ECG
                 # window (members pick ONE lead; the serving pack ships
                 # all three once and lead-selects on device)
ECG_HZ = 250
VITALS_HZ = 1
CLIP_SECONDS = 30

"""Per-acuity-tier serving state: the port of ``repro/control/tiers.py``.
The unit of controller actuation is a TIER, not the fleet.

HOLMES composes ensembles "for different targets ... and potentially
personalized predictions"; clinically, not every bed deserves the same
degradation behaviour under load.  This module partitions patients into
acuity tiers (``critical``/``elevated``/``stable`` by default,
re-assignable at runtime as a patient's state evolves) and gives each
tier its OWN ``(selector, placement)`` pair and degradation-ladder rung:

* ``TierRegistry``  — thread-safe patient -> tier map with runtime
  re-assignment and one-step ``escalate`` (mid-stay acuity changes);
* ``TieredEnsemble`` — one ``HotSwapper`` per tier over a SHARED
  ``StagingCache``: tiers standing on the same rung serve through the
  same staged service (one param stack, one warmed dispatch set), and
  pin-aware eviction means one tier's churn can never evict another
  tier's live pair.  All swappers share one ladder family (cheapest ->
  richest), so rung indices are comparable across tiers — the
  substrate of the priority-aware shed-order invariant
  (``control.controller.TieredController``): a stable bed is never on
  a richer rung than a critical bed.

The data-plane side (per-tier query routing and within-tier
micro-batching) lives in ``serving.server``/``serving.queues``; this
module is the control-plane state those route through.

The reference calls the per-tier swappers "lanes"; here they are
``swappers`` (``TieredEnsemble.swappers``, ``swapper(tier)``,
``swapper_metrics()``), because a lane in this package is only a
``repro_torch.device.Lane`` (``StagingCache.swappers`` likewise).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.control.swap import HotSwapper, StagingCache, rungs_monotone

# shed-first -> shed-last: the LAST tier is the highest acuity and
# holds the rich ensemble until the predicted bound leaves no choice
TIER_ORDER = ("stable", "elevated", "critical")


class TierRegistry:
    """Thread-safe patient-id -> acuity-tier map, re-assignable at
    runtime.  Unknown patients default to ``default`` (the lowest
    acuity unless configured otherwise): a bed the platform knows
    nothing about sheds first, never holds capacity hostage."""

    def __init__(self, tiers: Sequence[str] = TIER_ORDER,
                 default: Optional[str] = None):
        if not tiers:
            raise ValueError("tiers must be non-empty")
        self.tiers = tuple(tiers)
        self.default = default if default is not None else self.tiers[0]
        if self.default not in self.tiers:
            raise ValueError(f"default {self.default!r} not in "
                             f"{self.tiers}")
        self._lock = threading.Lock()
        self._tier: Dict[int, str] = {}

    def assign(self, patient: int, tier: str) -> None:
        if tier not in self.tiers:
            raise ValueError(f"unknown tier {tier!r} (have {self.tiers})")
        with self._lock:
            self._tier[patient] = tier

    def tier_of(self, patient: int) -> str:
        with self._lock:
            return self._tier.get(patient, self.default)

    def escalate(self, patient: int) -> str:
        """Move the patient one tier up (toward the last, highest-acuity
        tier); returns the new tier.  Already-top patients stay put."""
        with self._lock:
            cur = self._tier.get(patient, self.default)
            i = self.tiers.index(cur)
            new = self.tiers[min(i + 1, len(self.tiers) - 1)]
            self._tier[patient] = new
            return new

    def discharge(self, patient: int) -> None:
        with self._lock:
            self._tier.pop(patient, None)

    def census(self) -> Dict[str, int]:
        """Known patients per tier (excludes defaulted unknowns)."""
        with self._lock:
            out = {t: 0 for t in self.tiers}
            for t in self._tier.values():
                out[t] += 1
            return out


class TieredEnsemble:
    """One ``HotSwapper`` per acuity tier over a shared pool and a
    shared ``StagingCache``.

    Every swapper walks the SAME cheapest->richest ladder family
    (``set_ladder``), each at its own rung, so rung positions are
    comparable across tiers and identical (selector, placement) pairs
    are staged ONCE regardless of how many tiers stand on them.  The
    batch-aware server routes each flush through ``predict_batch(batch,
    tier)`` — one tier per flush, so cross-patient micro-batching
    coalesces patients within a tier only.
    """

    def __init__(self, pool: Sequence,
                 initial: Union[np.ndarray,
                                Mapping[str, np.ndarray]],
                 tiers: Sequence[str] = TIER_ORDER,
                 registry: Optional[TierRegistry] = None,
                 **swapper_kwargs):
        if not tiers:
            raise ValueError("tiers must be non-empty")
        self.tiers = tuple(tiers)
        self.registry = registry if registry is not None \
            else TierRegistry(self.tiers)
        self.staging = StagingCache()
        self.swappers: Dict[str, HotSwapper] = {}
        for t in self.tiers:
            sel = initial[t] if isinstance(initial, Mapping) else initial
            self.swappers[t] = HotSwapper(pool, sel, staging=self.staging,
                                          **swapper_kwargs)

    # --------------------------------------------------------- ladders
    def set_ladder(self, selectors: Sequence[np.ndarray],
                   prestage: bool = True) -> None:
        """Install ONE cheapest->richest family on every swapper (staged
        once thanks to the shared cache)."""
        for t in self.tiers:
            self.swappers[t].set_ladder(selectors, prestage=prestage)
            prestage = False          # the first swapper staged them

    def swapper(self, tier: str) -> HotSwapper:
        return self.swappers[tier]

    def rungs(self) -> Dict[str, int]:
        return {t: self.swappers[t].ladder_pos for t in self.tiers}

    def monotone(self) -> bool:
        """Shed-order invariant: rung positions are non-decreasing along
        the tier order (a stable bed never richer than a critical
        one).  Off-ladder swappers (-1) break comparability and count as
        a violation."""
        return rungs_monotone(self.swappers, self.tiers)

    def swapper_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-tier swapper state for the metrics exporter: current
        ladder rung and active ensemble size."""
        out: Dict[str, Dict[str, float]] = {}
        for t in self.tiers:
            sw = self.swappers[t]
            sel = getattr(sw, "active_selector", None)
            n_members = (float(np.asarray(sel).sum())
                         if sel is not None else float("nan"))
            out[t] = {"rung": float(sw.ladder_pos),
                      "n_members": n_members}
        return out

    # -------------------------------------------------------- data path
    def tier_of(self, patient: int) -> str:
        return self.registry.tier_of(patient)

    def predict(self, windows, tier: Optional[str] = None) -> float:
        return self.predict_batch([windows], tier)[0]

    def predict_batch(self, batch, tier: Optional[str] = None
                      ) -> List[float]:
        """One flush through ONE tier's live service (the tier-keyed
        batcher guarantees a flush never mixes tiers)."""
        t = tier if tier is not None else self.registry.default
        return self.swappers[t].facade.predict_batch(batch)

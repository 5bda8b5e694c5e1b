"""Zero-downtime selector hot-swap + degradation ladder (the control
plane's actuator): the port of ``repro/control/swap.py``.  Its three
device sites (``placement_for``, ``_drift_placement``,
``quarantine_device``) read the swapper's lane list
(``repro_torch.device.Lane``; default ``device_lanes()``, one lane a
card), so N lanes on one card are N devices to the planner, the
service, the fault guard and quarantine alike.

``SwappableService`` is the atomically swappable facade the server's
workers call: a micro-batch flush grabs a reference to the current
``EnsembleService`` under the lock and completes on it even if a swap
lands mid-flush, while the NEXT flush sees the new service — the ingest
queue and batcher are never touched, so no query is ever dropped by a
swap.

``HotSwapper`` owns the expensive part off the hot path: building the
new selector's stacked bucket params and warming its fused passes
(``EnsembleService`` staging), so the swap itself is a pointer flip.
It extends ``SelectorLadder`` — an ordered cheapest-to-richest family
of selectors the controller walks: ``shed`` steps down to a cheaper
ensemble under overload, ``climb`` steps back up when load recedes.

Staging warms the full pow2 flush-size ladder (default ``(1, 2, 4,
8)``), and the warmup inputs are the module-shared window packs of
``pipeline._warmup_pack`` — a recomposition that stages a new
(selector, placement) pair re-uses the same (length, flush-size)
window buffers, so hot-swap staging never re-materializes windows.
The data plane's window representation is selector-independent (one
``[Ppad, leads, L]`` pack per flush, or ``DeviceWindowRef``s into the
device-resident ingest rings), so a swap landing mid-stream changes
WHICH stacked params the next flush dispatches against, never how its
windows are built: device-ingest refs keep flowing through
``facade.predict_batch`` across recompose / re_place with zero
re-marshaling.

Placement is the second actuated dimension: with ``n_devices > 1`` (or
an explicit ``placement_fn``) ``stage`` pre-stages ``(selector,
placement)`` PAIRS — the selector's stacked bucket params sharded
across lanes per an LPT plan over measured bucket costs — and
``re_place`` re-derives the plan from freshly measured costs and swaps
it in under the SAME selector (the controller's RE-PLACE action).

Tiered serving shares one ``StagingCache`` across many ladders (one
lane per acuity tier, ``control.tiers.TieredEnsemble``): two tiers
standing on the same (selector, placement) pair serve through the SAME
staged service — one param stack, one warmed dispatch set — and
eviction keeps every ladder's active pair pinned, so tier A churning
through novel pairs can never evict tier B's live service.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike, Lane, as_lanes
from repro_torch.serving.placement import Placement, placement_signature

log = logging.getLogger(__name__)


class StagingCache:
    """Shared (selector, placement)-keyed staging state for one or more
    ``HotSwapper``s over the same member pool.

    Holds the staged-service / measurement-service / derived-placement
    caches plus the locks that guard them, and a per-swapper PIN of each
    swapper's active composite key.  Eviction
    (``HotSwapper._evict_stale``) computes its keep-set across ALL
    registered swappers — actives via the pins, ladder rungs by reading
    each swapper's rung list — so a multi-tier deployment staging T
    tiers x R rungs reuses identical pairs instead of duplicating them,
    and no swapper's churn can evict another swapper's live pair.
    """

    def __init__(self):
        self.lock = threading.Lock()       # guards the cache dicts + pins
        self.build_lock = threading.Lock()  # serializes expensive builds
        self.staged: Dict[bytes, object] = {}
        self.measure: Dict[bytes, object] = {}
        self.placements: Dict[bytes, Optional[Placement]] = {}
        self.swappers: List["HotSwapper"] = []
        self.pins: Dict[int, bytes] = {}   # id(swapper) -> active pair key

    def register(self, swapper: "HotSwapper") -> None:
        with self.lock:
            self.swappers.append(swapper)

    def unregister(self, swapper: "HotSwapper") -> None:
        """Retire a swapper (e.g. a tier being rebuilt on the shared
        cache): drop its pin and stop counting its active/ladder in
        eviction keep-sets — without this a dead swapper's staged
        services would be retained forever."""
        with self.lock:
            self.swappers = [w for w in self.swappers
                             if w is not swapper]
            self.pins.pop(id(swapper), None)

    def pin(self, swapper: "HotSwapper", key: bytes) -> None:
        with self.lock:
            self.pins[id(swapper)] = key


def rungs_monotone(ladders, order) -> bool:
    """The shed-order invariant: every ladder on-rung, rung positions
    non-decreasing along ``order`` (shed-first -> shed-last) — a stable
    bed is never on a richer rung than a critical bed.  Shared by
    ``control.tiers.TieredEnsemble`` and the tiered controller so the
    two can never disagree about what monotone means."""
    pos = [ladders[t].ladder_pos for t in order]
    return all(p >= 0 for p in pos) and all(
        a <= b for a, b in zip(pos, pos[1:]))


class SwappableService:
    """Atomic indirection over the live ``EnsembleService``."""

    def __init__(self, service):
        self._lock = threading.Lock()
        self._service = service
        self.swap_count = 0

    @property
    def current(self):
        with self._lock:
            return self._service

    def swap(self, new_service):
        """Atomically install ``new_service``; returns the old one.
        In-flight flushes keep their reference and finish on the old
        service — the swap lands between flushes."""
        with self._lock:
            old, self._service = self._service, new_service
            self.swap_count += 1
            return old

    # hot-path delegates (bind these as the server's handlers)
    def predict(self, windows) -> float:
        return self.current.predict(windows)

    def predict_batch(self, batch) -> List[float]:
        return self.current.predict_batch(batch)


class SelectorLadder:
    """Degradation ladder over binary selectors, cheapest -> richest.

    Subclasses implement ``_activate(selector)`` to make a selector
    live; the base class tracks the active selector and the ladder
    position.  All transitions go through ``swap_to`` so the activation
    hook is the single swap point.
    """

    def __init__(self, initial_selector: np.ndarray):
        self.active_selector = np.asarray(initial_selector, np.int8).copy()
        self._ladder: List[np.ndarray] = []
        self._pos = -1
        # reentrant: shed()/climb() read the ladder and then swap_to()
        # under the same lock, and a concurrent set_ladder (e.g. the
        # background recompose rebuilding the family) must not let them
        # index a rung that no longer exists
        self._swap_lock = threading.RLock()

    # ------------------------------------------------------------ ladder
    def set_ladder(self, selectors: Sequence[np.ndarray]) -> None:
        """Install the cheapest->richest family (the active selector
        keeps serving; its rung is found by match, -1 if off-ladder)."""
        with self._swap_lock:
            self._ladder = [np.asarray(s, np.int8).copy()
                            for s in selectors]
            self._pos = self._find(self.active_selector)

    def _find(self, selector: np.ndarray) -> int:
        for i, s in enumerate(self._ladder):
            if np.array_equal(s, selector):
                return i
        return -1

    @property
    def ladder(self) -> List[np.ndarray]:
        return [s.copy() for s in self._ladder]

    @property
    def ladder_pos(self) -> int:
        return self._pos

    def can_shed(self) -> bool:
        return self._pos > 0

    def can_climb(self) -> bool:
        return bool(self._ladder) and 0 <= self._pos < len(self._ladder) - 1

    def shed(self) -> bool:
        """Step DOWN to the next cheaper rung (overload relief)."""
        with self._swap_lock:
            if not self.can_shed():
                return False
            self.swap_to(self._ladder[self._pos - 1])
            return True

    def climb(self) -> bool:
        """Step UP to the next richer rung (load receded)."""
        with self._swap_lock:
            if not self.can_climb():
                return False
            self.swap_to(self._ladder[self._pos + 1])
            return True

    # ------------------------------------------------------------- swap
    def swap_to(self, selector: np.ndarray) -> None:
        sel = np.asarray(selector, np.int8).copy()
        with self._swap_lock:
            self._activate(sel)
            self.active_selector = sel
            self._pos = self._find(sel)

    def _activate(self, selector: np.ndarray) -> None:
        raise NotImplementedError


class HotSwapper(SelectorLadder):
    """Pre-stages ``EnsembleService``s for selectors over a shared
    member pool and swaps them into the ``facade`` atomically.

    ``stage`` is the expensive step (param stacking + warm-up) and
    runs OFF the hot path — by the controller's background thread, or
    eagerly for every ladder rung via ``set_ladder(prestage=True)``.
    Staged services are cached by selector, so ladder oscillation
    (shed/climb/shed) never restages.

    ``devices`` is the lane list (distinct ``Lane``s; default
    ``device_lanes()``, the same default as ``EnsembleService`` and
    ``FaultPlane.arm``); ``device`` is where unsharded services and the
    cost-measurement service live (default: the first lane's device).
    """

    def __init__(self, pool: Sequence, initial_selector: np.ndarray,
                 vitals_model=None, labs_model=None,
                 warmup_batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 fused: bool = True, impl: Optional[str] = None,
                 n_devices: int = 1,
                 devices: Optional[Sequence[Lane]] = None,
                 placement_fn: Optional[
                     Callable[[np.ndarray], Placement]] = None,
                 cost_reps: int = 3,
                 staging: Optional[StagingCache] = None,
                 speeds: Optional[Sequence[float]] = None,
                 plan_batch: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__(initial_selector)
        self.pool = list(pool)
        # fault-plane seam: when set, called with every service stage()
        # hands out (including cache hits), so a chaos harness can arm
        # each service's dispatch_guard no matter which swap installed it
        self.service_hook: Optional[Callable] = None
        self.quarantined: List = []        # lanes removed by fault recovery
        self._devices_gen = 0              # bumped by quarantine_device
        # called as hook(device, svc) AFTER a successful quarantine
        # swap, with the survivor facade's new service — the seam a
        # SlotEngine (which holds a direct service ref, not the
        # facade) uses to learn about flush-path failovers.  Hooks may
        # run on the failover thread; they must not block on locks the
        # triggering dispatch path might hold.
        self.quarantine_hooks: List[Callable] = []
        self.vitals_model = vitals_model
        self.labs_model = labs_model
        self.warmup_batch_sizes = tuple(warmup_batch_sizes)
        self.fused = fused
        self.impl = impl
        # placement actuation: n_devices > 1 shards staged services via
        # LPT over measured bucket costs; placement_fn overrides the
        # derivation (deterministic plans for tests / external planners)
        self.n_devices = n_devices
        self.devices = as_lanes(devices) if devices is not None else None
        # home device of unsharded and measurement services
        self.device = device if device is not None or not self.devices \
            else self.devices[0].device
        self.placement_fn = placement_fn
        self.cost_reps = cost_reps
        # heterogeneous pool: speeds[i] is devices[i]'s relative speed
        # (work units/s vs the reference device costs are measured on);
        # None == homogeneous.  Quarantine keeps the SURVIVOR
        # sub-vector aligned with the shrunken device list.
        self.speeds = list(speeds) if speeds is not None else None
        if self.speeds is not None and any(s <= 0 for s in self.speeds):
            raise ValueError(f"speeds must be > 0: {self.speeds}")
        # flush rung bucket costs are measured at when planning (None =
        # the pipeline's representative PLAN_BATCH default)
        self.plan_batch = plan_batch
        self.active_placement: Optional[Placement] = None
        # staging may be SHARED between swappers (per-acuity-tier ladders
        # over one pool): identical (selector, placement) pairs then
        # resolve to one staged service, and eviction is pin-aware
        # across every swapper registered on the cache
        self._staging = staging if staging is not None else StagingCache()
        self._staging.register(self)
        self._placements = self._staging.placements
        self._measure_cache = self._staging.measure
        self._staged = self._staging.staged
        self._stage_lock = self._staging.lock
        self._build_lock = self._staging.build_lock
        self.facade = SwappableService(self.stage(initial_selector))
        self.active_placement = self.placement_for(initial_selector)
        self._staging.pin(self, self._skey(self.active_selector,
                                           self.active_placement))

    @property
    def sharded(self) -> bool:
        return self.placement_fn is not None or self.n_devices > 1

    # -------------------------------------------------------- placement
    def placement_for(self, selector: np.ndarray,
                      fresh: bool = False) -> Optional[Placement]:
        """The selector's device plan (None when unsharded).  Plans are
        cached per selector so ladder oscillation reuses staged shards;
        ``fresh=True`` re-measures bucket costs and re-runs LPT — the
        re-derivation recompose/RE-PLACE triggers ask for."""
        if not self.sharded:
            return None
        key = np.asarray(selector, np.int8).tobytes()
        with self._stage_lock:
            if not fresh and key in self._placements:
                return self._placements[key]
        if self.placement_fn is not None:
            pl = self.placement_fn(np.asarray(selector, np.int8))
        else:
            # clamp to the real lane pool: an n_devices beyond it
            # would plan parallelism that cannot exist (the service
            # refuses such plans rather than folding slots silently)
            k = min(self.n_devices, len(self._lanes()))
            msvc = self._measure_service(selector)
            pl = msvc.plan_placement(k, reps=self.cost_reps,
                                     batch=self.plan_batch,
                                     speeds=self._slot_speeds(k)) \
                if len(msvc.members) else None
        with self._stage_lock:
            self._placements[key] = pl
        return pl

    def _lanes(self) -> List[Lane]:
        """The live lane pool: the swapper's own, else ``device_lanes()``
        (the service's and the fault plane's default)."""
        return list(self.devices) if self.devices is not None \
            else as_lanes(None)

    def _slot_speeds(self, k: int) -> Optional[List[float]]:
        """The first ``k`` device speeds (plan slots map onto the first
        k devices of the pool); None for a homogeneous pool."""
        if self.speeds is None:
            return None
        if len(self.speeds) < k:
            raise ValueError(f"{len(self.speeds)} speeds < {k} "
                             f"plan slots")
        return list(self.speeds[:k])

    def _measure_service(self, selector: np.ndarray):
        """Unsharded service used to measure bucket costs, cached per
        selector: only the TIMING must be fresh on re-derivation —
        re-stacking the whole selected zoo's params each time would
        multiply actuation latency for an identical result.  It lives
        on the swapper's home device, the lanes' device on one card."""
        from repro_torch.serving.pipeline import EnsembleService
        key = np.asarray(selector, np.int8).tobytes()
        with self._stage_lock:
            svc = self._measure_cache.get(key)
        if svc is None:
            svc = EnsembleService.for_selector(
                self.pool, selector, fused=True, impl=self.impl,
                device=self.device)
            with self._stage_lock:
                svc = self._measure_cache.setdefault(key, svc)
        return svc

    def _skey(self, selector: np.ndarray,
              placement: Optional[Placement]) -> bytes:
        return np.asarray(selector, np.int8).tobytes() + b"|" \
            + placement_signature(placement)

    def stage(self, selector: np.ndarray,
              placement: Optional[Placement] = None):
        """Build + warm the (selector, placement) service: stacked
        bucket params (on their lanes' devices when placed), every
        fused pass run once at the pow2 flush sizes.  ``placement=None``
        derives the selector's plan (or stays unsharded).  Idempotent:
        cached per pair; concurrent staging of the same pair waits on
        the build lock instead of duplicating the expensive
        stack-and-warm."""
        from repro_torch.serving.pipeline import EnsembleService
        sel = np.asarray(selector, np.int8)
        if placement is None:
            placement = self.placement_for(sel)
        key = self._skey(sel, placement)
        with self._stage_lock:
            svc = self._staged.get(key)
        if svc is not None:
            return self._arm(svc)
        with self._build_lock:
            with self._stage_lock:             # built while we waited?
                svc = self._staged.get(key)
            if svc is not None:
                return self._arm(svc)
            svc = EnsembleService.for_selector(
                self.pool, sel, vitals_model=self.vitals_model,
                labs_model=self.labs_model, fused=self.fused,
                impl=self.impl, placement=placement,
                devices=self.devices, device=self.device)
            if len(svc.members):
                svc.warmup(batch_sizes=self.warmup_batch_sizes)
            with self._stage_lock:
                self._staged[key] = svc
            return self._arm(svc)

    def _arm(self, svc):
        hook = self.service_hook
        if hook is not None:
            hook(svc)
        return svc

    def set_ladder(self, selectors: Sequence[np.ndarray],
                   prestage: bool = True) -> None:
        super().set_ladder(selectors)
        if prestage:
            for s in self._ladder:
                self.stage(s)

    def _activate(self, selector: np.ndarray) -> None:
        pl = self.placement_for(selector)
        self.facade.swap(self.stage(selector, pl))
        self.active_placement = pl
        self._staging.pin(self, self._skey(selector, pl))
        self._evict_stale(selector)

    def re_place(self, placement: Optional[Placement] = None) -> bool:
        """Hot-swap the ACTIVE selector onto a new device plan — the
        controller's RE-PLACE action.  ``placement=None`` re-derives
        the LPT plan from MEASURED DRIFT first: the live service's
        per-shard retire EWMAs (``live_bucket_costs``) reflect what
        devices are actually doing right now — a device that slowed
        down shows up there, never in a fresh offline measurement pass
        on the reference device.  Only when no live costs exist yet
        (no flush observed, or a non-bucket-aligned plan) does it fall
        back to the fresh offline measurement.  Returns True iff the
        plan actually changed (a no-op re-derivation must not cost a
        swap or start a controller cooldown).

        The expensive steps — cost measurement and staging — run
        OUTSIDE ``_swap_lock``, so an emergency shed/climb is never
        blocked behind a rebalance; only the pointer flip is locked.
        """
        with self._swap_lock:
            sel = self.active_selector.copy()
            gen = self._devices_gen
        pl = placement
        if pl is None:
            pl = self._drift_placement(sel)
        if pl is None:
            pl = self.placement_for(sel, fresh=True)
        if placement_signature(pl) \
                == placement_signature(self.active_placement):
            return False
        svc = self.stage(sel, pl)          # build/warm off the lock
        with self._swap_lock:
            if not np.array_equal(sel, self.active_selector):
                return False   # raced a selector swap, whose own
                               # activation derived a fresh plan
            if gen != self._devices_gen:
                return False   # raced a device quarantine: this plan
                               # may still reference the dead device
            with self._stage_lock:
                self._placements[np.asarray(sel, np.int8).tobytes()] = pl
            self.facade.swap(svc)
            self.active_placement = pl
            self._staging.pin(self, self._skey(sel, pl))
            self._evict_stale(sel)
            return True

    def _drift_placement(self, sel: np.ndarray) -> Optional[Placement]:
        """LPT plan re-derived from the ACTIVE service's live shard
        retire EWMAs (device-independent work units — de-normalized by
        each shard's slot speed), at the current slot count and speed
        sub-vector.  None when drift can't drive a plan: an external
        ``placement_fn`` owns planning, the deployment is unsharded, or
        the live service hasn't observed every bucket yet."""
        if self.placement_fn is not None or not self.sharded:
            return None
        svc = self.facade.current
        live = getattr(svc, "live_bucket_costs", None)
        costs = live() if callable(live) else None
        if costs is None or not len(getattr(svc, "members", ())):
            return None
        k = min(self.n_devices, len(self._lanes()))
        return svc.plan_placement(k, bucket_costs=costs,
                                  speeds=self._slot_speeds(k))

    @staticmethod
    def _failover_placement(old: Optional[Placement],
                            dead_slot: int) -> Optional[Placement]:
        """Minimal-move interim plan after losing ``dead_slot``: every
        surviving slot keeps its members (same buckets, same shapes,
        same lane), and only the dead slot's members move, onto the
        least-loaded survivor.  Deliberately unbalanced: failover
        optimizes time-to-first-correct-score; the controller's
        RE-PLACE rebalances in the background once the imbalance shows
        up in its service profile."""
        if old is None or not (0 <= dead_slot < old.n_slots) \
                or old.n_slots < 2:
            return None
        assignment = [list(s) for s in old.assignment]
        loads = list(old.loads)
        speeds = None if old.speeds is None else [
            s for i, s in enumerate(old.speeds) if i != dead_slot]
        moved, moved_load = assignment.pop(dead_slot), loads.pop(dead_slot)
        # least-FINISH-TIME survivor absorbs the orphans: on a
        # heterogeneous pool the least-loaded slot may be the slowest
        j = int(np.argmin([l / speeds[i] if speeds is not None else l
                           for i, l in enumerate(loads)]))
        assignment[j] = assignment[j] + moved
        loads[j] += moved_load
        return Placement(assignment=assignment, loads=loads,
                         speeds=speeds)

    def quarantine_device(self, device) -> bool:
        """Remove a dead lane from the pool and hot-swap the ACTIVE
        selector onto a plan over the survivors — the device-loss
        recovery path (``control.faults.FaultPlane``; ``device`` is the
        lost ``Lane``).

        Two-phase: the swap lands on a MINIMAL-MOVE interim plan
        (``_failover_placement`` — only the dead slot's members change
        lane), and the proper LPT rebalance is left to
        the controller's RE-PLACE action, which sees the interim plan's
        imbalance in its service profile.  Only when no usable prior
        plan exists does failover fall back to a full fresh derivation.

        Returns False when failover is impossible: an unsharded
        deployment (everything lives on the one default device) or a
        lane not in this swapper's pool.  No query is dropped on the
        way through: the ingest queue and batcher are untouched, the
        facade swap is atomic, and the flush that observed the loss
        simply retries on the recovered service.

        Every staged service and cached plan is invalidated wholesale —
        any of them may hold stacked params on the dead lane; swappers
        sharing the staging cache restage lazily on their next swap.
        """
        if not self.sharded:
            return False
        with self._swap_lock:
            devs = self._lanes()
            if device not in devs or len(devs) <= 1:
                return False
            dead_slot = devs.index(device)
            devs.remove(device)
            self.devices = devs
            self.n_devices = min(self.n_devices, len(devs))
            if self.speeds is not None and dead_slot < len(self.speeds):
                # survivor speed sub-vector stays aligned with devices
                self.speeds = (list(self.speeds[:dead_slot])
                               + list(self.speeds[dead_slot + 1:]))
            self._devices_gen += 1
            sel = self.active_selector.copy()
            old_pl = self.active_placement
        with self._stage_lock:
            self._staged.clear()
            self._placements.clear()
        pl = self._failover_placement(old_pl, dead_slot)
        if pl is None:
            pl = self.placement_for(sel, fresh=True)
        svc = self.stage(sel, pl)          # build/warm off the swap lock
        with self._swap_lock:
            if not np.array_equal(sel, self.active_selector):
                # raced a shed/climb: restage for the NEW active so the
                # live service is guaranteed off the dead device
                sel = self.active_selector.copy()
                pl = self.placement_for(sel, fresh=True)
                svc = self.stage(sel, pl)
            with self._stage_lock:
                self._placements[np.asarray(sel, np.int8).tobytes()] = pl
            self.facade.swap(svc)
            self.active_placement = pl
            self._staging.pin(self, self._skey(sel, pl))
        self.quarantined.append(device)
        for hook in list(self.quarantine_hooks):
            try:
                hook(device, svc)
            except Exception:
                log.exception("quarantine hook failed")
        return True

    def _evict_stale(self, active: np.ndarray) -> None:
        """Drop staged services that are neither active nor a ladder
        rung: under drifting load every recompose can yield a novel
        (selector, placement) pair, and each staged service holds
        stacked param copies — without eviction a long-running
        deployment leaks until OOM.  (A service still
        finishing an in-flight flush stays alive via the flush's
        reference.)

        With a SHARED staging cache the keep-set spans every registered
        swapper: each one's active pair via its pin (the pin carries the
        exact composite key, so a swapper whose recorded placement for a
        selector was refreshed by ANOTHER swapper's re-derivation keeps
        its live pair regardless), plus every swapper's ladder rungs.
        Other swappers' rung lists are read without their swap locks —
        they are replaced wholesale under set_ladder, and a stale read
        can only over-retain for one cycle, never evict a pinned
        active."""
        with self._swap_lock:
            rungs = [np.asarray(active, np.int8)] + list(self._ladder)
        for other in list(self._staging.swappers):
            if other is self:
                continue
            rungs.append(np.asarray(other.active_selector, np.int8))
            rungs.extend(list(other._ladder))
        with self._stage_lock:
            keep = {s.tobytes() + b"|"
                    + placement_signature(self._placements.get(
                        s.tobytes())) for s in rungs}
            keep |= set(self._staging.pins.values())
            for k in [k for k in self._staged if k not in keep]:
                del self._staged[k]
            keep_sel = {s.tobytes() for s in rungs}
            keep_sel |= {k.split(b"|", 1)[0]
                         for k in self._staging.pins.values()}
            for k in [k for k in self._measure_cache
                      if k not in keep_sel]:
                del self._measure_cache[k]

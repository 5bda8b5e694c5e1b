"""Slot-based continuous serving engine: the port of
``repro/serving/slots.py`` (one device; the sharded groups of a
placement come with the placement slice).

The flush path (``pipeline.EnsembleService.predict_batch``) is
query-oriented: every micro-batch re-marshals refs, pads, dispatches
and gathers.  Continuous monitoring inverts that: every bed streams
*all the time*, so the score should be an always-fresh per-patient
STATE that queries merely read.

``SlotEngine`` keeps exactly that state:

* each bed owns a **slot** — its window state already lives in the
  ``DeviceIngest`` ring buffers (``[n_patients, channels, capacity]``
  per modality, written in place by ingest); the engine adds the
  host-side slot bookkeeping (occupancy, last-closed-window ints,
  close/score versions) plus a persistent member-score matrix
  ``[M, Spad]`` float32 on the service's device per device group;
* ``tick()`` scores **all occupied slots at once**: one ring gather
  per distinct window length (``gather_windows``, the CUDA
  ``window_gather`` kernel on the card — the same call the flush
  makes), the *same stacked bucket passes* as the flush
  (``pipeline._bucket_scores``, every conv one launch of
  ``conv1d_stripe_stacked``), and ONE in-place masked fold per device
  group that writes the freshly scored columns into the member-score
  state and leaves the ``[Spad]`` member mean on the device
  (``device_scores``);
* a query becomes "read slot k's latest score" — host int indexing
  into the engine's mirror, **zero transfers and zero launches per
  query**.  The tick's ``n_buckets`` passes amortize over every
  occupied slot.

Bitwise oracle contract
-----------------------
The tick calls the flush's own bucket function and the fold merely
*selects* freshly computed columns, so a slot's score is
bitwise-identical to ``predict_batch`` over the same refs AT THE SAME
PAD RUNG, provided the bucket forward gives a window the same bits at
every row of a batch (the tests hold both the plain versions and the
kernels to that).  The host ``read()`` surface replicates
``EnsembleService._combine``'s float64 mean + CPU-side vitals/labs
models verbatim from one per-tick readback of the member-score matrix,
so even the combined score matches the oracle bit for bit.  (The
on-device ``device_scores`` vector is the float32 zoo mean and is NOT
the oracle surface.)

The ring is written in place (``serving.aggregator``), so the tick
takes its staleness check, its view of the rings and its gather
launches under ONE hold of ``DeviceIngest.lock``, as the flush does; a
chunk queued after the lock is released runs on the same stream after
the gathers.

Staleness is a tick-age guard: a slot whose ring data was overwritten
before the tick could gather it (the same two-host-int check the
flush uses) is skipped — its mirror keeps the last good score and its
score version stops advancing, so version-gated readers
(``wait_scored``) time out to NaN instead of serving wrong-window
data.

``SlotTicker`` drives ``tick()`` from a daemon thread at a writable
interval, ``TickerWatchdog`` respawns it when it dies or goes quiet,
and ``TickLadder`` exposes the interval as a degradation ladder with
the ``shed``/``climb``/``swap_to`` protocol of the control plane's
selector ladder.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.aggregator import (DeviceIngest, DeviceWindowRef,
                                            gather_windows, pow2_rung,
                                            to_device)
from repro_torch.serving.pipeline import _bucket_scores, _lead_expand

log = logging.getLogger(__name__)

_DEVICE_LOST_CLS = None


def _device_lost(e: BaseException) -> bool:
    """True when ``e`` is the fault plane's ``DeviceLostError``.  Lazily
    imported so the serving layer never depends on
    ``repro_torch.control`` at import time (the control plane builds on
    serving)."""
    global _DEVICE_LOST_CLS
    if _DEVICE_LOST_CLS is None:
        try:
            from repro_torch.control.faults import DeviceLostError
            _DEVICE_LOST_CLS = DeviceLostError
        except Exception:               # control plane absent: nothing
            return False                # can raise its error type
    return isinstance(e, _DEVICE_LOST_CLS)


def _masked_update(state: torch.Tensor, cands: Sequence[torch.Tensor],
                   occ: torch.Tensor) -> torch.Tensor:
    """The slot-state fold: write this tick's freshly scored member
    columns (``cands``, one ``[m_i, S]`` block per bucket in group
    order) into the persistent ``[M_g, S]`` float32 ``state`` IN PLACE
    behind the occupancy mask ``occ`` ``[S]``, and return the group's
    ``[S]`` member mean.  ``where`` only SELECTS columns, so a scored
    slot's state is bitwise the bucket pass's output and an unscored
    slot's column keeps its bits."""
    torch.where(occ[None, :], torch.cat(list(cands)), state, out=state)
    return state.mean(dim=0)


def _fleet_mean(mats: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Cross-group combine for sharded plans: the ``[S]`` member mean
    over every device group's score matrix (brought to ``device``
    first)."""
    return torch.cat([m.to(device) for m in mats]).mean(dim=0)


@dataclasses.dataclass
class _Group:
    """Per-device slice of the tick: the buckets run on one device plus
    that device's persistent member-score state."""
    device: Optional[torch.device]  # None = the service's own device
    buckets: List                   # pipeline._Bucket, plan order
    rows: np.ndarray                # global member index per state row
    state: Optional[torch.Tensor]   # [M_g, Spad] float32, folded in place


@dataclasses.dataclass
class TickReport:
    """What one ``tick()`` did (the bench/telemetry surface).

    ``stamped``/``versions``/``scores`` name the slots whose mirror
    actually ADVANCED this tick (the ABA/version guards can drop a
    computed score), aligned index-for-index — together with ``spad``
    (the pad rung the tick dispatched at) they are exactly what an
    offline oracle needs to re-score the tick bitwise."""
    tick: int                       # tick ordinal after this tick
    n_scored: int                   # occupied slots scored this tick
    n_stale: int                    # occupied slots skipped (ring overrun)
    seconds: float                  # wall clock of the whole tick
    scored: np.ndarray              # slot ids scored this tick
    stamped: Optional[np.ndarray] = None   # slot ids whose mirror advanced
    versions: Optional[np.ndarray] = None  # close version per stamped slot
    scores: Optional[np.ndarray] = None    # combined score per stamped slot
    spad: int = 0                   # pad rung (oracle batch size)
    skipped: bool = False           # tick-lock timeout: nothing ran


def _check_service(service, what: str) -> None:
    if not getattr(service, "fused", False):
        raise ValueError(f"{what} needs a fused EnsembleService")
    if getattr(service, "marshal", "packed") != "packed":
        raise ValueError(f"{what} needs the packed marshal (the tick "
                         "gathers windows on the device)")


class SlotEngine:
    """Persistent patient-slot scoring over a ``DeviceIngest`` census.

    ``service`` must be a fused, packed-marshal ``EnsembleService`` on
    the same device as ``ingest``, the census's ``DeviceIngest`` (slot
    k == patient k — a bed owns its ring row).

    Host API (all thread-safe):

    * ``admit(slot)`` / ``discharge(slot)`` — slot insert / free;
    * ``update(ref)`` — record a closed window for its slot (admits on
      first window), returns the slot's new close VERSION;
    * ``tick()`` — score all occupied slots once (see module doc);
    * ``read(slot)`` — the slot's latest combined score, host int
      indexing only (NaN before the first scoring or past the tick-age
      guard); ``wait_scored(slot, version)`` blocks until the tick
      covering that close version lands.
    """

    def __init__(self, service, ingest: DeviceIngest):
        _check_service(service, "SlotEngine")
        if not service.members:
            raise ValueError("SlotEngine needs at least one zoo member")
        if "ecg" not in ingest.states:
            raise ValueError("SlotEngine needs an 'ecg' ingest ring")
        if ingest.device != service.device:
            raise ValueError(f"SlotEngine needs the ingest rings on the "
                             f"service's device: ingest on "
                             f"{ingest.device}, service on "
                             f"{service.device}")
        self.service = service
        self.ingest = ingest
        self.n_slots = ingest.n_patients
        self._Spad = pow2_rung(self.n_slots)
        self._lens = tuple(sorted({b.spec.input_len
                                   for b in service._buckets}))
        self.groups: List[_Group] = self._build_groups(service)
        # [Spad] f32 combined (zoo-mean) score vector, stays on device
        self.device_scores: Optional[torch.Tensor] = None
        # gather rows: slot k reads ring row k; pad rows read row 0
        # with valid 0 (all zeros)
        self._pj = np.pad(np.arange(self.n_slots, dtype=np.int64),
                          (0, self._Spad - self.n_slots))

        # ---- tick serialization + fault recovery ----
        # one tick (or growth, or rebind) at a time; REENTRANT so the
        # device-loss hook may rebind from inside a failing tick.  A
        # respawned ticker generation that finds the lock held (a
        # zombie tick still in flight) SKIPS rather than piling up.
        self._tick_lock = threading.RLock()
        self.tick_lock_timeout = 2.0
        self.max_tick_retries = 3
        # on_device_lost(err) -> bool: installed by the fault plane
        # (``FaultPlane.protect_engine``); True means "recovered, re-run
        # the tick", False/None means abort (the error propagates and
        # the NEXT tick retries naturally — right for transient losses)
        self.on_device_lost = None
        self.on_tick = None             # on_tick(TickReport), post-tick
        self._pre_stamp_hook = None     # test seam: runs between the
        #                                 readback and the stamp lock
        self._pending_rebind = None     # service queued by request_rebind

        # ---- host slot state (all guarded by _lock) ----
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.occupied = np.zeros(self.n_slots, bool)
        self.has_window = np.zeros(self.n_slots, bool)
        self._ends = {m: np.zeros(self.n_slots, np.int64)
                      for m in ingest.states}
        self._valid = {m: np.zeros(self.n_slots, np.int64)
                       for m in ingest.states}
        self._extra: List[Dict] = [{} for _ in range(self.n_slots)]
        self._close_version = np.zeros(self.n_slots, np.int64)
        self.scored_version = np.full(self.n_slots, -1, np.int64)
        self.last_scored_tick = np.full(self.n_slots, -1, np.int64)
        self._admit_epoch = np.zeros(self.n_slots, np.int64)
        self.mirror = np.full(self.n_slots, np.nan)   # float64 oracle
        self.tick_count = 0
        # counters (bench surface)
        self.dispatch_count = 0      # stacked bucket passes by ticks
        self.n_admits = 0
        self.n_discharges = 0
        self.n_stale_total = 0
        self.tick_seconds = 0.0
        self.n_tick_faults = 0       # DeviceLostError raised inside a tick
        self.n_tick_aborts = 0       # ticks abandoned (fault, no recovery)
        self.n_tick_skips = 0        # ticks skipped on the tick lock
        self.n_rebinds = 0           # post-failover service rebinds
        self.n_grows = 0             # census regrowths (ensure_slots)

    def _build_groups(self, service) -> List[_Group]:
        """The device groups in bucket-plan order, each with a ZERO
        member-score state at the current pad rung.  Every bucket of
        the port's service runs on the service's own device, so there
        is one group, keyed None as the reference keys its default
        device (placement, a later slice, adds one a device)."""
        buckets = list(service._buckets)
        rows = np.asarray([i for b in buckets for i in b.idx])
        return [_Group(device=None, buckets=buckets, rows=rows,
                       state=torch.zeros((len(rows), self._Spad),
                                         dtype=torch.float32,
                                         device=service.device))]

    def rebind(self, service) -> None:
        """Point the engine at a new ``EnsembleService`` — the
        post-failover step: a swapper's ``quarantine_device`` re-stages
        onto the survivor pool and swaps its facade, but the engine
        holds a DIRECT service ref, so the fault plane (or a
        quarantine hook) must rebind it.  Idempotent; the member
        composition must be unchanged (failover moves shards, it never
        drops members) and so must the device of the ingest rings.
        Group states restart at zero — every occupied slot is fully
        re-scored by the next tick anyway, and the host mirror keeps
        its last good scores in the gap (stale, never wrong)."""
        if service is self.service:
            return
        _check_service(service, "rebind")
        old = [getattr(m, "name", None) for m in self.service.members]
        new = [getattr(m, "name", None) for m in service.members]
        if old != new:
            raise ValueError(f"rebind must keep the member composition "
                             f"({old} -> {new})")
        if service.device != self.ingest.device:
            raise ValueError(f"rebind needs a service on the ingest's "
                             f"device {self.ingest.device}, got "
                             f"{service.device}")
        with self._tick_lock:
            self.service = service
            self._lens = tuple(sorted({b.spec.input_len
                                       for b in service._buckets}))
            self.groups = self._build_groups(service)
            self.device_scores = None
            with self._lock:
                self.n_rebinds += 1

    def request_rebind(self, service) -> None:
        """Queue a rebind to be applied at the next tick.  The async
        form exists for a swapper's ``quarantine_hooks``: a hook can
        fire on the failover thread WHILE a tick (waiting on that very
        failover) holds the tick lock — a synchronous ``rebind`` there
        would deadlock."""
        with self._lock:
            self._pending_rebind = service

    # ------------------------------------------------------ slot admin
    def admit(self, slot: int) -> None:
        """Insert a bed into its slot (idempotent), growing the census
        when ``slot`` is past the current capacity.  The slot serves
        NaN until its first window is closed and ticked."""
        if slot >= self.n_slots:
            self.ensure_slots(slot + 1)
        with self._lock:
            if self.occupied[slot]:
                return
            self._admit_locked(slot)

    def acquire_slot(self) -> int:
        """Admit into the lowest FREE slot and return its id, growing
        the census when every slot is occupied — the free-list admit
        path for callers that track beds, not slot ids."""
        while True:
            with self._lock:
                free = np.flatnonzero(~self.occupied)
                if len(free):
                    s = int(free[0])
                    self._admit_locked(s)
                    return s
                want = self.n_slots + 1
            self.ensure_slots(want)   # racers just re-loop

    def ensure_slots(self, n: int) -> int:
        """Grow the census to hold at least ``n`` slots, under live
        ticks, and return the new capacity.  Growth goes in pow2 steps
        (``pow2_rung``) so slot count and pad rung stay aligned and
        regrowths amortize.  Serialized against ``tick()`` on the tick
        lock: a tick in flight finishes on the OLD shapes, the next one
        sees the grown census.  Existing slots keep their scores,
        versions and ring rows bitwise; the group states are
        zero-padded along the slot axis, which keeps every live column
        exactly."""
        if n <= self.n_slots:
            return self.n_slots
        with self._tick_lock:
            if n <= self.n_slots:     # lost the growth race: done
                return self.n_slots
            new_n = int(pow2_rung(n))
            old_spad = self._Spad
            new_spad = int(pow2_rung(new_n))
            self.ingest.grow(new_n)
            add = new_n - self.n_slots
            with self._lock:
                self.occupied = np.pad(self.occupied, (0, add))
                self.has_window = np.pad(self.has_window, (0, add))
                for m in list(self._ends):
                    self._ends[m] = np.pad(self._ends[m], (0, add))
                    self._valid[m] = np.pad(self._valid[m], (0, add))
                self._extra.extend({} for _ in range(add))
                self._close_version = np.pad(self._close_version,
                                             (0, add))
                self.scored_version = np.pad(
                    self.scored_version, (0, add), constant_values=-1)
                self.last_scored_tick = np.pad(
                    self.last_scored_tick, (0, add), constant_values=-1)
                self._admit_epoch = np.pad(self._admit_epoch, (0, add))
                self.mirror = np.pad(self.mirror, (0, add),
                                     constant_values=np.nan)
                self.n_slots = new_n
                self._Spad = new_spad
                self.n_grows += 1
            self._pj = np.pad(np.arange(self.n_slots, dtype=np.int64),
                              (0, self._Spad - self.n_slots))
            if new_spad != old_spad:
                for g in self.groups:
                    g.state = torch.nn.functional.pad(
                        g.state, (0, new_spad - old_spad))
                self.device_scores = None
            return self.n_slots

    def _admit_locked(self, slot: int) -> None:
        self.occupied[slot] = True
        self.has_window[slot] = False
        self.mirror[slot] = np.nan
        self.scored_version[slot] = -1
        self.last_scored_tick[slot] = -1
        self._admit_epoch[slot] += 1
        self._extra[slot] = {}
        self.n_admits += 1

    def discharge(self, slot: int) -> None:
        """Free the bed's slot.  Its mirror score is cleared and any
        reader still waiting on it wakes to NaN; the state column is
        simply masked out of future ticks until re-admission closes a
        fresh window."""
        with self._lock:
            if not self.occupied[slot]:
                raise KeyError(f"slot {slot} is not occupied")
            self.occupied[slot] = False
            self.has_window[slot] = False
            self.mirror[slot] = np.nan
            self.scored_version[slot] = -1
            self._extra[slot] = {}
            self.n_discharges += 1
            self._cv.notify_all()

    def update(self, ref: DeviceWindowRef) -> int:
        """Record a closed observation window for its slot (admitting
        the bed on its first window) and return the slot's new close
        version — ``wait_scored(slot, version)`` then blocks until the
        tick that covers this window has landed.  Only the ref's host
        integers are touched; the samples stay in the rings."""
        if ref.ingest is not self.ingest:
            raise ValueError("ref belongs to a different DeviceIngest")
        s = ref.patient
        if s >= self.n_slots:      # ingest grown out-of-band: catch up
            self.ensure_slots(s + 1)
        with self._lock:
            if not self.occupied[s]:
                self._admit_locked(s)
            for m in ref.ends:
                self._ends[m][s] = ref.ends[m]
                self._valid[m][s] = ref.valid[m]
            self._extra[s] = dict(ref.extra)
            self.has_window[s] = True
            self._close_version[s] += 1
            return int(self._close_version[s])

    # ------------------------------------------------------------ tick
    def _stale_mask(self, occ: np.ndarray, ends: Dict[str, np.ndarray],
                    valid: Dict[str, np.ndarray]) -> np.ndarray:
        """Slots whose last-closed window has been overwritten in a
        ring the tick will read — the flush path's staleness guard,
        vectorized over slots.  Checked for the ECG ring always and
        the vitals ring iff the tick's side-model readback uses it.
        Reads ``ingest.fed``: call under ``ingest.lock``."""
        need = {"ecg": max(self._lens)}
        if self.service.vitals_model is not None \
                and "vitals" in self.ingest.states:
            need["vitals"] = self.ingest.want["vitals"]
        stale = np.zeros(self.n_slots, bool)
        for m, l_need in need.items():
            cap = int(self.ingest.states[m].buf.shape[-1])
            fed = self.ingest.fed[m][:self.n_slots]
            oldest = ends[m] - np.minimum(valid[m], l_need)
            stale |= occ & ((fed - oldest) > cap)
        return stale

    def _occ_device(self, mask: np.ndarray) -> torch.Tensor:
        """The ``[Spad]`` occupancy mask on the service's device (every
        group's state lives there until placement lands)."""
        return to_device(np.pad(mask, (0, self._Spad - self.n_slots)),
                         self.service.device)

    def tick(self) -> TickReport:
        """Score every occupied, non-stale slot once: ring gathers +
        the flush path's stacked bucket passes + one in-place masked
        fold per device group, then refresh the host mirror with the
        oracle-exact combined scores.

        Fault contract: every gather and bucket dispatch runs behind
        the service's ``dispatch_guard``, and ALL guards fire before
        the first fold — a ``DeviceLostError`` aborts the tick with
        every group's persistent score state untouched (a
        partially-failed tick can never be folded in).  When
        ``on_device_lost`` is installed and recovers (quarantine +
        rebind), the tick re-runs; otherwise the error propagates and
        the next tick retries.  Concurrent ticks serialize on the tick
        lock; a caller that cannot acquire it within
        ``tick_lock_timeout`` returns a ``skipped`` report instead of
        piling up behind a stalled zombie tick."""
        if not self._tick_lock.acquire(timeout=self.tick_lock_timeout):
            with self._lock:
                self.n_tick_skips += 1
                return TickReport(self.tick_count, 0, 0, 0.0,
                                  np.zeros(0, np.int64),
                                  spad=self._Spad, skipped=True)
        try:
            with self._lock:
                pending = self._pending_rebind
                self._pending_rebind = None
            if pending is not None:
                try:
                    self.rebind(pending)    # reentrant on the tick lock
                except Exception:
                    log.exception("queued rebind failed")
            attempts = 0
            while True:
                try:
                    report = self._tick_attempt()
                    break
                except Exception as e:
                    if not _device_lost(e):
                        raise
                    with self._lock:
                        self.n_tick_faults += 1
                    hook = self.on_device_lost
                    attempts += 1
                    if hook is not None \
                            and attempts <= self.max_tick_retries \
                            and hook(e):
                        continue        # recovered: re-run the tick
                    with self._lock:
                        self.n_tick_aborts += 1
                        self._cv.notify_all()
                    raise
        finally:
            self._tick_lock.release()
        cb = self.on_tick
        if cb is not None:
            try:
                cb(report)
            except Exception:
                log.exception("on_tick callback failed")
        return report

    def _tick_attempt(self) -> TickReport:
        t0 = time.perf_counter()
        svc = self.service
        ingest = self.ingest
        with self._lock:
            spad = self._Spad
            pj = self._pj
            occ = self.occupied & self.has_window
            ends = {m: a.copy() for m, a in self._ends.items()}
            valid = {m: a.copy() for m, a in self._valid.items()}
            versions = self._close_version.copy()
            epochs = self._admit_epoch.copy()
            extras = list(self._extra)
        pad = spad - len(occ)
        vitals = svc.vitals_model is not None and "vitals" in ingest.states
        guard = svc.dispatch_guard

        # ---- phase 1: gather + dispatch.  No persistent state is
        # touched and every guard fires HERE, so a DeviceLostError
        # anywhere in this phase aborts with all group states intact.
        # The rings are written in place: the staleness check, the view
        # of the rings and the gather launches take ONE hold of the
        # ingest lock, so no chunk lands between check and gather.
        vit = None
        with ingest.lock:
            stale = self._stale_mask(occ, ends, valid)
            mask = occ & ~stale
            scored = np.flatnonzero(mask)
            if len(scored):
                if guard is not None:
                    guard(None)   # the rings live on the service device
                # one gather per distinct window length, over ALL slots
                # (unscored and pad rows read valid 0: all zeros)
                st = ingest.states["ecg"]
                ej = np.pad(ends["ecg"], (0, pad))
                vj = np.pad(np.where(mask, valid["ecg"], 0), (0, pad))
                packs = {L: gather_windows(st.buf, pj, ej, vj, L,
                                           impl=svc.impl)
                         for L in self._lens}
                if vitals:
                    vit = gather_windows(
                        ingest.states["vitals"].buf, pj,
                        np.pad(ends["vitals"], (0, pad)),
                        np.pad(np.where(mask, valid["vitals"], 0),
                               (0, pad)),
                        ingest.want["vitals"], impl=svc.impl)
        empty = np.zeros(0, np.int64)
        if not len(scored):
            with self._lock:
                self.tick_count += 1
                self.n_stale_total += int(stale.sum())
                self.tick_seconds += time.perf_counter() - t0
                self._cv.notify_all()
                return TickReport(self.tick_count, 0, int(stale.sum()),
                                  time.perf_counter() - t0, scored,
                                  stamped=empty, versions=empty,
                                  scores=np.zeros(0), spad=spad)

        group_cands: List[List[torch.Tensor]] = []
        n_disp = 0
        for g in self.groups:
            cands = []
            for b in g.buckets:
                if guard is not None:
                    guard(g.device)
                cands.append(_bucket_scores(
                    b, _lead_expand(b, packs[b.spec.input_len]),
                    svc.impl))
            n_disp += len(g.buckets)
            group_cands.append(cands)

        # ---- phase 2: fold.  Every guard has passed; the in-place
        # folds commit each group's state for this tick.
        occ_dev = self._occ_device(mask)
        combined = None
        for g, cands in zip(self.groups, group_cands):
            combined = _masked_update(g.state, cands, occ_dev)
        self.device_scores = combined if len(self.groups) == 1 else \
            _fleet_mean([g.state for g in self.groups], svc.device)

        # host mirror: exact _combine numerics (float64 mean over the
        # member column + CPU-side vitals/labs models) from one small
        # readback per group — this sync point plays the flush's
        # score copy
        score_mat = np.zeros((len(svc.members), spad))
        for g in self.groups:
            score_mat[g.rows] = g.state.cpu().numpy()
        vit_rows = vit.cpu().numpy() if vit is not None else None
        fresh: Dict[int, float] = {}
        for s in scored:
            fresh[int(s)] = self._host_combine(
                score_mat[:, s], extras[s],
                vit_rows[s] if vit_rows is not None else None)

        hook = self._pre_stamp_hook
        if hook is not None:
            hook()

        wall = time.perf_counter() - t0
        stamped: List[int] = []
        with self._lock:
            self.tick_count += 1
            for s, sc in fresh.items():
                # a slot discharged (or churned to a new occupant, or
                # closed a NEWER window — whose samples the gather may
                # already have seen) while the tick was in flight must
                # not be stamped with this tick's score
                if not self.occupied[s] \
                        or self._admit_epoch[s] != epochs[s] \
                        or self._close_version[s] != versions[s]:
                    continue
                self.mirror[s] = sc
                self.scored_version[s] = versions[s]
                self.last_scored_tick[s] = self.tick_count
                stamped.append(s)
            self.dispatch_count += n_disp
            self.n_stale_total += int(stale.sum())
            self.tick_seconds += wall
            self._cv.notify_all()
            st_ids = np.asarray(stamped, np.int64)
            return TickReport(
                self.tick_count, len(scored), int(stale.sum()), wall,
                scored, stamped=st_ids,
                versions=versions[st_ids].copy(),
                scores=np.asarray([fresh[int(s)] for s in st_ids]),
                spad=spad)

    def _host_combine(self, score_col: np.ndarray, extra: Dict,
                      vit_row: Optional[np.ndarray]) -> float:
        """``EnsembleService._combine`` for one slot, verbatim: python
        list of float64 member scores, CPU-side models appended in the
        same order, ``np.mean`` over the list."""
        svc = self.service
        scores = list(score_col) if len(svc.members) else []
        if svc.vitals_model is not None:
            vit = vit_row if vit_row is not None else extra.get("vitals")
            if vit is not None:
                scores.append(float(
                    svc.vitals_model.predict_proba(vit[None])[0]))
        if svc.labs_model is not None:
            labs = extra.get("labs")
            if labs is not None:
                scores.append(float(
                    svc.labs_model.predict_proba(labs[None])[0]))
        return float(np.mean(scores)) if scores else 0.5

    # ------------------------------------------------------------ reads
    def read(self, slot: int,
             max_age_ticks: Optional[int] = None) -> float:
        """The slot's latest combined score — host int indexing, no
        device work at all.  NaN before the slot's first scoring, and
        NaN past the tick-age guard: ``max_age_ticks`` bounds how many
        ticks ago the score may have landed (a stale ring or a stopped
        ticker stops a slot's score version from advancing, and this
        guard keeps such a slot from serving an old score forever)."""
        with self._lock:
            if not self.occupied[slot]:
                raise KeyError(f"slot {slot} is not occupied")
            if self.scored_version[slot] < 0:
                return float("nan")
            if max_age_ticks is not None and (
                    self.tick_count - self.last_scored_tick[slot]
                    > max_age_ticks):
                return float("nan")
            return float(self.mirror[slot])

    def wait_scored(self, slot: int, version: int,
                    timeout: float = 1.0) -> bool:
        """Block until the tick covering close ``version`` of ``slot``
        has landed (True), or the slot was discharged / the timeout
        expired (False — the caller should serve NaN)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if not self.occupied[slot]:
                    return False
                if self.scored_version[slot] >= version:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))

    def scores(self) -> np.ndarray:
        """Snapshot of the host mirror: ``[n_slots]`` float64, NaN for
        unoccupied / not-yet-scored slots."""
        with self._lock:
            return np.where(self.occupied, self.mirror, np.nan)

    # ----------------------------------------------------------- warmup
    def warm(self) -> None:
        """Run everything a tick launches (ring gathers and bucket
        passes at the slot batch size) once, so the first tick pays no
        one-time cost (the kernel library build, allocator growth) on
        the serving path."""
        self.ingest.warm_gather(self._lens, batch_sizes=(self._Spad,))
        if self.service.vitals_model is not None \
                and "vitals" in self.ingest.states:
            self.ingest.warm_gather(
                (self.ingest.want["vitals"],),
                batch_sizes=(self._Spad,), modality="vitals")
        self.service.warmup(batch_sizes=(self._Spad,))


class SlotTicker:
    """Daemon-thread ticker: calls ``engine.tick()`` every
    ``interval`` seconds.  ``interval`` is a plain writable float read
    fresh each cycle — ``TickLadder`` actuates it live, no restart.

    The thread is GENERATIONAL (the server workers' epoch-token idiom):
    ``respawn()`` bumps the epoch and starts a fresh thread; the
    abandoned generation exits at its next epoch check, and even one
    wedged inside a tick is harmless — the engine's tick lock makes
    the new generation SKIP while the zombie finishes, and the
    zombie's eventual stamp is a normally-guarded, correct (if late)
    tick.  Every generation ever spawned stays in ``_threads`` so
    ``stop()`` joins them ALL — a watchdog-respawned ticker can never
    orphan a thread past the leak checker.

    ``beat`` is the watchdog heartbeat: ``(epoch, count, stamp)``
    advanced after each tick by the CURRENT generation only (a stale
    generation can never beat).  ``before_tick`` is the fault plane's
    stall hook: it returns a stall duration in seconds (0 for none)
    and the ticker sleeps it out WITHOUT beating — an injected
    ``ticker_stall`` looks exactly like a wedged tick to the watchdog.
    """

    def __init__(self, engine: SlotEngine, interval: float = 0.05,
                 name: str = "repro-ticker"):
        self.engine = engine
        self.interval = float(interval)
        self._base_name = name
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._epoch = 0
        self.n_respawns = 0
        self.before_tick = None    # () -> float stall seconds, or None
        self._beat = (0, 0, time.monotonic())
        self._threads: List[threading.Thread] = [
            threading.Thread(target=self._run, args=(0,), daemon=True,
                             name=name)]

    def start(self) -> "SlotTicker":
        self._threads[-1].start()
        return self

    def _is_current(self, epoch: int) -> bool:
        with self._lock:
            return epoch == self._epoch

    def _beat_now(self, epoch: int) -> None:
        with self._lock:
            if epoch == self._epoch:
                self._beat = (epoch, self._beat[1] + 1,
                              time.monotonic())

    @property
    def beat(self) -> Tuple[int, int, float]:
        """(epoch, tick-loop count, monotonic stamp) — the stamp also
        resets on ``respawn()`` so a fresh generation gets a full
        deadline of grace before the watchdog may judge it."""
        with self._lock:
            return self._beat

    def _run(self, epoch: int) -> None:
        while not self._stop.wait(self.interval):
            if not self._is_current(epoch):
                return
            hook = self.before_tick
            if hook is not None:
                try:
                    dur = float(hook() or 0.0)
                except Exception:
                    log.exception("before_tick hook failed")
                    dur = 0.0
                if dur > 0:
                    time.sleep(dur)     # injected stall: no beat
            if not self._is_current(epoch):
                return
            try:
                self.engine.tick()
            except Exception:
                log.exception("slot tick failed; ticker continues")
            self._beat_now(epoch)

    def respawn(self) -> bool:
        """Abandon the current generation and start a fresh one.
        No-op (False) once stopped."""
        with self._lock:
            if self._stop.is_set():
                return False
            self._epoch += 1
            epoch = self._epoch
            t = threading.Thread(
                target=self._run, args=(epoch,), daemon=True,
                name=f"{self._base_name}-r{epoch}")
            self._threads.append(t)
            self.n_respawns += 1
            self._beat = (epoch, self._beat[1], time.monotonic())
        t.start()
        return True

    def stop(self, join_timeout: float = 2.0) -> bool:
        """Stop and join EVERY generation ever spawned (watchdog
        respawns included); True only when all of them exited."""
        self._stop.set()
        deadline = time.monotonic() + join_timeout
        ok = True
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            ok &= not t.is_alive()
        return ok

    def alive_threads(self) -> List[str]:
        """Names of every still-running generation (the server's leak
        accounting surface)."""
        with self._lock:
            threads = list(self._threads)
        return [t.name for t in threads if t.is_alive()]

    @property
    def alive(self) -> bool:
        """True when the CURRENT generation's thread is running (an
        abandoned zombie doesn't count — it never ticks again)."""
        with self._lock:
            return self._threads[-1].is_alive()

    @property
    def name(self) -> str:
        with self._lock:
            return self._threads[-1].name


class TickerWatchdog:
    """Heartbeat watchdog over a ``SlotTicker``: a daemon poll loop
    that respawns the ticker when its current generation dies or its
    beat stamp goes quiet past the deadline (a wedged tick, an
    injected ticker stall).  Readers are already safe during the gap
    — ``read()``'s tick-age guard and ``wait_scored()``'s timeout
    surface NaN-or-stale, never a wrong score — so the watchdog's
    only job is to get ticks flowing again.

    The quiet threshold is ``deadline_seconds + ticker.interval``
    (read live, so a ``TickLadder`` shed to a slow rung doesn't read
    as a stall), and the beat stamp resets on every respawn, giving
    each new generation a full deadline of grace — no respawn storms.
    """

    def __init__(self, ticker: SlotTicker,
                 deadline_seconds: float = 1.0, poll: float = 0.05,
                 name: str = "repro-tickwatch"):
        if deadline_seconds <= 0:
            raise ValueError("deadline must be positive")
        self.ticker = ticker
        self.deadline = float(deadline_seconds)
        self.poll = float(poll)
        self.n_respawns = 0
        self.events: List[Dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self) -> "TickerWatchdog":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            epoch, _count, stamp = self.ticker.beat
            quiet = time.monotonic() - stamp
            dead = not self.ticker.alive
            if not dead and quiet <= self.deadline + self.ticker.interval:
                continue
            if self.ticker.respawn():
                self.n_respawns += 1
                self.events.append({
                    "cause": "dead" if dead else "stall",
                    "epoch": epoch, "quiet_s": round(quiet, 4)})
            else:
                return      # ticker stopped for good: nothing to guard

    def stop(self, join_timeout: float = 2.0) -> bool:
        self._stop.set()
        self._thread.join(timeout=join_timeout)
        return not self._thread.is_alive()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def name(self) -> str:
        return self._thread.name


class TickLadder:
    """Tick RATE as a degradation-ladder knob, duck-typing
    ``control.swap.SelectorLadder``'s shed/climb protocol so the
    adaptive controller can actuate it exactly like it sheds ensemble
    members: rung 0 is the cheapest (slowest tick — least device work
    per second), the last rung the richest (fastest tick — freshest
    scores).  ``shed()`` slows the tick, ``climb()`` speeds it up;
    both write ``ticker.interval`` atomically under the ladder lock.
    """

    def __init__(self, ticker: SlotTicker,
                 intervals: Sequence[float],
                 start: Optional[int] = None):
        rungs = sorted({float(i) for i in intervals}, reverse=True)
        if not rungs:
            raise ValueError("TickLadder needs at least one interval")
        if any(r <= 0 for r in rungs):
            raise ValueError("tick intervals must be positive")
        self.ticker = ticker
        self._ladder = rungs
        self._lock = threading.RLock()
        pos = len(rungs) - 1 if start is None else int(start)
        if not 0 <= pos < len(rungs):
            raise ValueError(f"start rung {pos} outside ladder of "
                             f"{len(rungs)}")
        self._pos = pos
        self._activate(rungs[pos])

    @property
    def ladder(self) -> List[float]:
        return list(self._ladder)

    @property
    def ladder_pos(self) -> int:
        return self._pos

    @property
    def active_interval(self) -> float:
        return self._ladder[self._pos]

    def can_shed(self) -> bool:
        return self._pos > 0

    def can_climb(self) -> bool:
        return self._pos < len(self._ladder) - 1

    def shed(self) -> bool:
        with self._lock:
            if not self.can_shed():
                return False
            self._pos -= 1
            self._activate(self._ladder[self._pos])
            return True

    def climb(self) -> bool:
        with self._lock:
            if not self.can_climb():
                return False
            self._pos += 1
            self._activate(self._ladder[self._pos])
            return True

    def swap_to(self, pos: int) -> None:
        with self._lock:
            if not 0 <= pos < len(self._ladder):
                raise ValueError(f"rung {pos} outside ladder of "
                                 f"{len(self._ladder)}")
            self._pos = pos
            self._activate(self._ladder[pos])

    def _activate(self, interval: float) -> None:
        self.ticker.interval = float(interval)

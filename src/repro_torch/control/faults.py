"""Deterministic fault-injection plane + recovery wiring (chaos drills):
the port of ``repro/control/faults.py`` without ``wire_controller``
(which needs the controller and comes with the control-plane slice).
Nothing here depends on a framework except ``FaultPlane.arm``, which
defaults its device list to ``device_lanes()`` (one ``Lane`` a CUDA
card), the same default as ``EnsembleService`` and ``HotSwapper``.

HOLMES's claim is always-on sub-second scoring; what makes that claim
believable is how the stack behaves when something breaks at 3am.  This
module is the seeded, replayable "something breaks": a declarative
schedule of ``FaultEvent``s that a ``FaultPlane`` fires against the
live serving stack, plus the recovery wiring that turns each fault into
a bounded, fully-accounted outcome instead of a wrong or missing score.

Fault kinds and their recovery contracts:

* ``device_loss`` — the plane's ``dispatch_guard`` (armed on every
  ``EnsembleService`` a swapper hands out, via ``service_hook``, or set
  by hand on a service) raises ``DeviceLostError`` the moment a flush
  or a slot tick would dispatch onto the lost device.  ``protect()``
  catches it in the server worker: a PERMANENT loss (duration 0)
  quarantines the device — the swapper's ``quarantine_device``
  (``control.swap.HotSwapper``) re-derives the placement over the
  surviving lanes and hot-swaps the active selector onto it — then the
  flush
  retries on the recovered service; a TRANSIENT loss (duration > 0,
  the only recoverable shape on a single-device pool) retries until the
  plane restores the device.  Either way the co-batched queries are
  served late, never dropped and never mis-scored.

* ``worker_stall`` — ``protect()`` consumes a stall token and sleeps
  ``duration`` inside exactly one worker's handler.  The server's
  watchdog (``EnsembleServer(deadline_seconds=...)``) detects the hang,
  retires the in-flight co-batch NaN (the standard failure score),
  respawns the worker, and the staleness guards refuse any window the
  stall outlived — a stalled query yields NaN, never a stale score.

* ``backpressure`` — an advisory episode: while active, the trace
  replayer overruns the ingest side (``backpressure_active()``), and the
  bounded ``ShedQueue`` + priority-aware admission shed the stable tier
  first, counting every rejection in ``ServerStats``.

* ``ticker_stall`` — the slot-engine analogue of ``worker_stall``: the
  ``SlotTicker``'s ``before_tick`` hook (wired by ``protect_engine``)
  consumes a token and sleeps it out WITHOUT heart-beating, so the
  ``TickerWatchdog`` must detect the quiet beat and respawn the ticker;
  readers ride the gap on the tick-age guard (NaN-or-stale, never a
  wrong score).

``protect()`` guards the flush/worker path; ``protect_engine()`` is the
same contract for the continuous slot path — every tick gather and
bucket dispatch runs behind ``guard``, a loss aborts the tick BEFORE
the in-place fold, and recovery (quarantine + engine rebind, optionally
shedding the ``TickLadder`` while shards restage) re-ticks onto the
survivor placement.

Everything is driven by an injectable MONOTONIC clock relative to
``arm()`` time (wall-clock steps must never shear event timing in long
soaks), so the same schedule replays identically run to run; schedules
round-trip through ``to_json``/``from_json`` as committed trace files.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import as_lanes, device_lanes

log = logging.getLogger(__name__)

FAULT_KINDS = ("device_loss", "worker_stall", "backpressure",
               "ticker_stall")


class DeviceLostError(RuntimeError):
    """Raised by the armed dispatch guard when a flush or a slot tick
    would dispatch onto a device the fault plane has marked lost.
    ``device`` is the lost lane (None past the plane's device list),
    ``index`` its place in that list."""

    def __init__(self, device, index: int):
        super().__init__(f"device {index} ({device}) lost")
        self.device = device
        self.index = index


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``t`` is seconds after ``arm()``;
    ``target`` is a device index for ``device_loss`` (ignored
    otherwise); ``duration`` is the stall length / backpressure episode
    length / transient-loss length — 0 makes a device loss PERMANENT
    (recovery must come from quarantine + re-placement, not from the
    device coming back)."""
    t: float
    kind: str
    target: int = 0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    def to_dict(self) -> Dict:
        return {"t": self.t, "kind": self.kind, "target": self.target,
                "duration": self.duration}


class FaultPlane:
    """Seeded, declarative fault injector for the serving stack.

    Usage::

        plane = FaultPlane(schedule).arm(swapper)
        handler = plane.protect(score_fn, swapper)   # server worker path
        srv = EnsembleServer(batch_handler=..., deadline_seconds=0.25)

    ``arm`` hooks the swapper so every staged ``EnsembleService`` gets
    the plane's ``dispatch_guard`` — a swap mid-run cannot escape
    injection — and starts the schedule clock.  All state transitions
    are time-driven from the schedule (no randomness at fire time; the
    seed exists for schedule *generators*), so a run is replayable.
    """

    def __init__(self, schedule: Sequence[FaultEvent], seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.schedule = sorted(schedule, key=lambda e: e.t)
        self.seed = seed
        self.clock = clock
        self._lock = threading.RLock()
        self._armed_at: Optional[float] = None
        self._pending: List[FaultEvent] = list(self.schedule)
        self._lost: Dict[int, FaultEvent] = {}     # device idx -> event
        self._stalls: List[FaultEvent] = []        # unconsumed stall tokens
        self._ticker_stalls: List[FaultEvent] = []  # ticker stall tokens
        self._bp: List[FaultEvent] = []            # backpressure episodes
        self.devices: List = []
        self.fired: List[Tuple[float, FaultEvent]] = []
        self.recoveries: List[Dict] = []           # what recovered, when, how
        self.swapper = None
        # one failover thread ever per lost device index: the worker
        # that trips the loss starts it, every other worker (and every
        # retry) just waits on it — presence in the dict marks the
        # attempt so a failed quarantine is not re-run forever
        self._failover_threads: Dict[int, threading.Thread] = {}

    # ------------------------------------------------------------- arming
    def arm(self, swapper=None, devices: Optional[Sequence] = None
            ) -> "FaultPlane":
        """Start the schedule clock and hook the serving stack: the
        swapper's ``service_hook`` arms every service it stages (past
        and future) with this plane's dispatch guard.  ``devices``
        (device index -> the value a service's guard is called with: a
        ``Lane`` of a placement) defaults to the swapper's own lanes
        (a copy, fixed at arming: quarantine shrinks the swapper's list,
        never the plane's indices), else to ``device_lanes()``, one
        lane a CUDA card, and arming raises when there is none.  A
        sharded service is armed only against lanes: every lane it runs
        on must be in ``devices``, and every scheduled loss must name
        one of them, or no fault could ever fire on it."""
        if devices is None:
            devices = getattr(swapper, "devices", None)
        self.devices = list(devices) if devices is not None \
            else device_lanes()
        if swapper is not None:             # refused before any hook
            self._arm_service(swapper.facade.current)
            swapper.service_hook = self._arm_service
        self._armed_at = self.clock()
        self.swapper = swapper
        return self

    def _arm_service(self, svc) -> None:
        if getattr(svc, "placement", None) is not None:
            self._check_lanes(svc.devices)
        svc.dispatch_guard = self.guard

    def _check_lanes(self, used: Sequence) -> None:
        """Refuse to arm a sharded service the guard cannot match: its
        lanes outside this plane's list, or a scheduled loss beyond
        it (a bare ``torch.device`` list is refused by ``as_lanes``)."""
        devs = as_lanes(self.devices)
        stray = [d for d in used if d not in devs]
        if stray:
            raise ValueError(f"the service runs on {stray}, which the "
                             f"fault plane's lanes {devs} do not hold")
        far = sorted({e.target for e in self.schedule
                      if e.kind == "device_loss"
                      and not 0 <= e.target < len(devs)})
        if far:
            raise ValueError(f"device_loss targets {far} lie beyond the "
                             f"plane's {len(devs)} lane(s)")

    def now(self) -> float:
        """Seconds since ``arm()`` on the plane's MONOTONIC clock —
        never wall time, so a host clock step cannot shear a schedule
        mid-soak."""
        if self._armed_at is None:
            raise RuntimeError("FaultPlane not armed")
        return self.clock() - self._armed_at

    # ------------------------------------------------------------- firing
    def _tick(self) -> None:
        with self._lock:
            if self._armed_at is None:
                return          # pre-arm probe (e.g. a ticker hook
            t = self.now()      # wired before the schedule starts)
            while self._pending and self._pending[0].t <= t:
                ev = self._pending.pop(0)
                self.fired.append((t, ev))
                log.info("fault fired at t=%.3f: %s", t, ev)
                if ev.kind == "device_loss":
                    self._lost[ev.target] = ev
                elif ev.kind == "worker_stall":
                    self._stalls.append(ev)
                elif ev.kind == "ticker_stall":
                    self._ticker_stalls.append(ev)
                else:
                    self._bp.append(ev)
            # transient losses expire on their own (the device "reboots")
            for idx, ev in list(self._lost.items()):
                if ev.duration > 0 and t >= ev.t + ev.duration:
                    del self._lost[idx]
                    self.recoveries.append(
                        {"t": t, "kind": "device_restored", "target": idx})

    def _device_of(self, index: int):
        return self.devices[index] if index < len(self.devices) else None

    def guard(self, device) -> None:
        """The ``EnsembleService.dispatch_guard``: called with the
        bucket's lane (None = an unsharded service's own device, index
        0) immediately before each stacked dispatch.  Devices compare
        by equality: a ``Lane`` equals only a lane of the same index on
        the same ``torch.device`` (never a bare ``torch.device``), so
        the loss of lane 2 of four on one card stops lane 2 alone."""
        self._tick()
        with self._lock:
            for idx, ev in self._lost.items():
                dev = self._device_of(idx)
                if device == dev or (device is None and idx == 0):
                    raise DeviceLostError(dev, idx)

    def stall_pending(self) -> float:
        """Consume one due stall token; returns the stall duration (0.0
        when none due).  Exactly one caller gets each token, so one
        scheduled stall hangs exactly one worker."""
        self._tick()
        with self._lock:
            if self._stalls:
                return self._stalls.pop(0).duration
        return 0.0

    def ticker_stall_pending(self) -> float:
        """Consume one due ticker-stall token; returns the stall
        duration (0.0 when none due).  This IS the ``SlotTicker``'s
        ``before_tick`` hook (wired by ``protect_engine``), so it is
        safe to call before ``arm()`` — the ticker usually starts
        first."""
        self._tick()
        with self._lock:
            if self._ticker_stalls:
                return self._ticker_stalls.pop(0).duration
        return 0.0

    def backpressure_active(self) -> bool:
        """True while a backpressure episode is in progress — the trace
        replayer's cue to overrun the ingest side."""
        self._tick()
        with self._lock:
            if self._armed_at is None:
                return False
            t = self.now()
            return any(ev.t <= t < ev.t + max(ev.duration, 1e-9)
                       for ev in self._bp)

    def active_losses(self) -> Dict[int, FaultEvent]:
        self._tick()
        with self._lock:
            return dict(self._lost)

    def done(self) -> bool:
        self._tick()
        with self._lock:
            return not self._pending

    # ----------------------------------------------------------- recovery
    def _failover(self, err: DeviceLostError, swapper,
                  beat: Callable[[], bool], retry_sleep: float) -> None:
        """Quarantine the lost device in a SIDE thread while the
        triggering worker heart-beats: a failover restage takes real
        seconds (the moved buckets restage), and a worker silently
        blocked inside it would read as a hang to the server's watchdog
        — its co-batch NaN-failed mid-recovery.  Exactly one thread is
        ever started per device index; every other worker that trips
        the same loss waits on it here."""
        with self._lock:
            th = self._failover_threads.get(err.index)
            if th is None:
                def _run():
                    if swapper.quarantine_device(err.device):
                        self.recoveries.append(
                            {"t": self.now(), "kind": "quarantined",
                             "target": err.index})
                        log.info("quarantined device %d; re-placed "
                                 "onto survivors", err.index)
                    else:
                        log.warning("quarantine of device %d failed "
                                    "(no survivors?)", err.index)
                th = threading.Thread(
                    target=_run, name=f"repro-failover-{err.index}",
                    daemon=True)
                self._failover_threads[err.index] = th
                th.start()
        while th.is_alive():
            beat()
            th.join(retry_sleep)

    def protect(self, score_fn: Callable, swapper=None,
                heartbeat: Optional[Callable[[], bool]] = None,
                retry_budget_s: float = 60.0,
                retry_sleep: float = 0.02) -> Callable:
        """Wrap a batch scoring function with stall injection and
        device-loss recovery; the result is what the server's workers
        call.

        On ``DeviceLostError``: a permanent loss triggers
        ``swapper.quarantine_device`` in a side thread (minimal-move
        re-place onto survivors) and retries on the recovered facade; a
        transient loss (or a pool with no survivor) retries on a short
        sleep until the plane restores the device.  Throughout the wait
        the wrapper calls ``heartbeat`` (pass the server's
        ``heartbeat`` method) so the watchdog knows the co-batch is
        alive and recovering — an injected STALL deliberately never
        heart-beats, so the watchdog still catches real hangs.  The
        co-batch is never dropped: either a retry eventually serves it,
        or the ``retry_budget_s`` is exhausted and the raised error
        lands in the server's NaN-isolation path — still accounted,
        still never mis-scored.
        """
        swapper = swapper if swapper is not None else self.swapper

        def beat() -> bool:
            if heartbeat is None:
                return True
            try:
                return bool(heartbeat())
            except Exception:
                return True

        def guarded(windows, *rest):
            dur = self.stall_pending()
            if dur > 0:
                log.info("injected worker stall: %.3fs", dur)
                time.sleep(dur)       # silent: the watchdog MUST fire
            # the retry budget runs on the plane's injectable MONOTONIC
            # clock — same timeline as the schedule, immune to wall steps
            t_give_up = self.clock() + retry_budget_s
            last_err = None
            while True:
                try:
                    return score_fn(windows, *rest)
                except DeviceLostError as e:
                    last_err = e
                    if self.clock() >= t_give_up or not beat():
                        raise last_err  # budget gone / co-batch already
                    #                     abandoned: NaN-isolation path
                    ev = self.active_losses().get(e.index)
                    permanent = ev is not None and ev.duration == 0
                    if permanent and swapper is not None:
                        self._failover(e, swapper, beat, retry_sleep)
                    else:
                        time.sleep(retry_sleep)  # transient: wait it out

        return guarded

    def protect_engine(self, engine, swapper=None, ticker=None,
                       tick_ladder=None,
                       retry_sleep: float = 0.02) -> "FaultPlane":
        """Extend injection + recovery into the continuous slot path —
        the tick-side sibling of ``protect()``:

        * ``ticker.before_tick`` consumes ticker-stall tokens (the
          stall sleeps in the ticker loop without beating, so the
          ``TickerWatchdog`` must catch it);
        * ``engine.on_device_lost`` becomes the tick recovery hook: a
          PERMANENT loss on a sharded pool sheds the ``TickLadder``
          one rung (cheaper ticks while the moved shards restage —
          undone right after), quarantines the device through the
          shared one-thread-per-index ``_failover`` path, rebinds the
          engine onto the survivor facade and returns True so the
          aborted tick re-runs; a TRANSIENT loss returns False — the
          tick aborts clean and the next tick retries once the device
          reboots;
        * the swapper's ``quarantine_hooks`` gain a rebind request, so
          a FLUSH-path quarantine (both engines live on one pool) also
          re-points the slot engine — lazily, at its next tick, since
          a hook firing mid-tick must not deadlock on the tick lock.
        """
        swapper = swapper if swapper is not None else self.swapper
        if ticker is not None:
            ticker.before_tick = self.ticker_stall_pending

        def _recover(err: DeviceLostError) -> bool:
            ev = self.active_losses().get(err.index)
            permanent = ev is not None and ev.duration == 0
            if not permanent or swapper is None:
                return False
            shed = tick_ladder is not None and tick_ladder.shed()
            try:
                self._failover(err, swapper, beat=lambda: True,
                               retry_sleep=retry_sleep)
            finally:
                if shed:
                    tick_ladder.climb()
            if err.device in getattr(swapper, "quarantined", []):
                engine.rebind(swapper.facade.current)
                return True
            return False

        engine.on_device_lost = _recover
        hooks = getattr(swapper, "quarantine_hooks", None)
        if hooks is not None:
            hooks.append(lambda device, svc: engine.request_rebind(svc))
        return self

    # -------------------------------------------------------- trace files
    def to_json(self, path: Optional[str] = None) -> str:
        """Serialize the SCHEDULE (not runtime state) as a replayable
        trace: committed alongside the bench results, it pins exactly
        which faults a soak survived."""
        payload = {"version": 1, "seed": self.seed,
                   "schedule": [ev.to_dict() for ev in self.schedule]}
        text = json.dumps(payload, indent=2) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, src,
                  clock: Callable[[], float] = time.monotonic
                  ) -> "FaultPlane":
        """Rebuild a plane from ``to_json`` output — accepts the
        parsed dict, the JSON text, or a path to a trace file."""
        if isinstance(src, dict):
            payload = src
        else:
            text = str(src)
            if not text.lstrip().startswith("{"):
                with open(text) as f:
                    text = f.read()
            payload = json.loads(text)
        events = [FaultEvent(t=float(ev["t"]), kind=str(ev["kind"]),
                             target=int(ev.get("target", 0)),
                             duration=float(ev.get("duration", 0.0)))
                  for ev in payload.get("schedule", [])]
        return cls(events, seed=int(payload.get("seed", 0)),
                   clock=clock)


# ------------------------------------------------- compound schedules
def compound_schedule(n_devices: int, seed: int = 0,
                      t0: float = 0.45) -> List[FaultEvent]:
    """Flush-path compound schedule: overlapping device losses, a loss
    DURING a backpressure episode, and a worker-stall cascade.
    Deterministic in (n_devices, seed) — the seed jitters timings,
    never the shape."""
    rng = np.random.default_rng(seed)

    def j(hi: float = 0.05) -> float:
        return float(rng.uniform(0.0, hi))

    ev = [FaultEvent(t0 + j(), "worker_stall", duration=0.6),
          FaultEvent(t0 + 0.1 + j(), "worker_stall", duration=0.5)]
    bp = t0 + 0.9 + j()
    ev.append(FaultEvent(bp, "backpressure", duration=0.6))
    if n_devices >= 2:
        # permanent loss inside the backpressure episode, with a
        # transient loss of a SECOND device overlapping the quarantine
        ev.append(FaultEvent(bp + 0.15 + j(), "device_loss", target=1))
        ev.append(FaultEvent(bp + 0.2 + j(), "device_loss",
                             target=2 if n_devices > 2 else 0,
                             duration=0.5))
    else:
        ev.append(FaultEvent(bp + 0.15 + j(), "device_loss", target=0,
                             duration=0.35))
        ev.append(FaultEvent(bp + 0.85 + j(), "device_loss", target=0,
                             duration=0.25))
    return sorted(ev, key=lambda e: e.t)


def slot_compound_schedule(n_devices: int, seed: int = 0,
                           t0: float = 0.45) -> List[FaultEvent]:
    """Slot-engine compound schedule: a ticker-stall cascade (the
    watchdog must respawn through BOTH stalls), then overlapping
    device losses during a backpressure episode.  No ``worker_stall``
    — the slot path's server workers only wait on versions; the stall
    surface is the ticker itself."""
    rng = np.random.default_rng(seed)

    def j(hi: float = 0.05) -> float:
        return float(rng.uniform(0.0, hi))

    ev = [FaultEvent(t0 + j(), "ticker_stall", duration=0.7),
          FaultEvent(t0 + 0.1 + j(), "ticker_stall", duration=0.5)]
    bp = t0 + 1.1 + j()
    ev.append(FaultEvent(bp, "backpressure", duration=0.6))
    if n_devices >= 2:
        ev.append(FaultEvent(bp + 0.15 + j(), "device_loss", target=1))
        ev.append(FaultEvent(bp + 0.2 + j(), "device_loss",
                             target=2 if n_devices > 2 else 0,
                             duration=0.5))
    else:
        # single device: transient losses are the only recoverable
        # shape — one inside backpressure, one after
        ev.append(FaultEvent(bp + 0.15 + j(), "device_loss", target=0,
                             duration=0.35))
        ev.append(FaultEvent(bp + 0.85 + j(), "device_loss", target=0,
                             duration=0.25))
    return sorted(ev, key=lambda e: e.t)

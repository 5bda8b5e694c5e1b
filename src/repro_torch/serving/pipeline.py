"""The served ensemble pipeline (Fig. 4): HTTP-ingest stand-in ->
stateful aggregators -> ensemble query -> bagging combine.  The port of
``repro/serving/pipeline.py``.

``EnsembleService`` runs the selected ECG zoo members on its device
(default ``cuda:0``), or over the lanes of a placement, plus the
CPU-side vitals/labs models; ``StreamingPipeline`` drives it from
per-patient multi-modal streams and records end-to-end wall-clock
latencies.

Fused serving (the hot path)
----------------------------
The zoo runs in **architecture buckets** (``configs.ecg_zoo
.bucket_zoo``): members with identical shapes are stacked along a
leading member axis (``launch.ensemble_parallel.stack_members``) and run
as ONE ``ecg_apply_stacked`` pass per bucket, in which every conv is one
launch of the member-stacked CUDA kernel.  ``predict_batch``
micro-batches windows from many patients into the same pass.  The
per-member loop is kept (``fused=False``) as the equivalence oracle and
for per-member cost measurement (``measured_costs``).

The one-transfer flush contract
-------------------------------
A flush ships each patient's raw ``[ECG_LEADS, L]`` window to the device
at most once, never once per stacked member: the host builds one
``[Ppad, ECG_LEADS, L]`` pack per distinct input length and every
bucket lead-gathers its members' rows on the device.  With
device-resident ingest (``serving.aggregator.DeviceIngest``) a batch of
``DeviceWindowRef``s skips even that copy: the pack is gathered out of
the rings (the CUDA ``window_gather`` kernel) and only the flushed
(patient, end, valid) int32 triples cross to the device.  The
pre-refactor member-expanded marshaling is kept as ``marshal="legacy"``.
``h2d_bytes`` / ``marshal_seconds`` account both regimes.

One CUDA graph a flush rung
---------------------------
A flush on the card is some hundreds (the narrow rung) to thousands
(the full zoo) of small operations, and issuing them one by one from
Python costs far more host time than the card spends on them.  So
``warmup`` captures, at each rung it warms, one ``torch.cuda.CUDAGraph``
of the whole bucketed forward: every bucket's ``_bucket_pass`` in bucket
order and the concatenation of their scores into one static ``[sum M,
Ppad]`` output, read from one static ``[Ppad, ECG_LEADS, L]`` pack a
distinct input length.  A flush at a captured rung copies its pack into
the static one, replays the graph and clones the output, all on the
service's own stream and under its graph lock (the two server workers
share the static buffers), then copies the clone back once.  The graph holds the very operations
the eager loop issues, so a replay is bitwise the eager flush.  The
service takes it wherever it can: a CUDA device, the fused path, the
packed marshal, no placement, and a graph at the flush's rung; every
other flush (the CPU, a placement, the legacy marshal, a rung not
captured) runs the eager loop.  ``graph_flushes`` and ``eager_flushes``
count the two.  The kernels' launch counters count a replay's launches
at the replay, as they count the eager loop's.

``impl`` (``None``, ``"torch"`` or ``"cuda"``, see ``kernels.ops``)
selects the kernels for every conv and gather of the service; ``None``
picks by device.  The continuous slot engine (``serving.slots``)
reuses this module's bucket passes (``StreamingPipeline(engine=
"slots")``).

Sharded serving (``placement=``)
--------------------------------
A ``serving.placement.Placement`` shards the stacked bucket params over
a list of lanes (``repro_torch.device.Lane``; default ``device_lanes()``,
one a card): each slot's members are bucketed on their own and every
(bucket, lane) shard holds its stacked params on the lane's device.  A
flush issues one stacked pass a shard, each behind
``dispatch_guard(lane)``, and copies the scores back once a distinct
``torch.device``.  Bucket-aligned plans (``plan_placement``'s) are
bitwise equal to the unsharded service: the stacked groups never
change, only where they run.  Lanes on one card share its stream, so
a 4-lane flush there runs the same launches as the unsharded one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.ecg_zoo import (CLIP_SECONDS, ECG_HZ, ECG_LEADS,
                                         EcgModelSpec, VITALS_HZ,
                                         bucket_zoo)
from repro_torch.device import (DeviceLike, Lane, as_lanes, resolve_device)
from repro_torch.kernels import _build
from repro_torch.launch.ensemble_parallel import stack_members
from repro_torch.models.ecg_resnext import (ecg_apply, ecg_apply_stacked,
                                            map_params)
from repro_torch.obs import spans as _spans
from repro_torch.serving.aggregator import (DeviceIngest, DeviceWindowRef,
                                            ModalitySpec,
                                            PatientAggregator,
                                            gather_windows, pow2_rung,
                                            to_device)
from repro_torch.serving.placement import Placement, grouped_lpt_placement


@dataclasses.dataclass
class ZooMember:
    spec: EcgModelSpec
    params: Dict


@dataclasses.dataclass
class _Bucket:
    """One stacked-execution group: structurally identical members.
    With a placement this is a (bucket, lane) SHARD — the same bucket
    may appear once per lane its members were assigned to."""
    spec: EcgModelSpec            # shape-defining representative
    idx: List[int]                # member indices into self.members
    leads: List[int]              # per stacked member, the lead it reads
    lead_index: torch.Tensor      # the same leads, on the device
    stacked: Dict                 # stack_members() tree, leading axis M
    device: Optional[Lane] = None  # the shard's lane (None: unsharded)
    slot: int = 0                 # placement slot index (0 if unsharded)

    @property
    def tdev(self) -> torch.device:
        """Where its tensors live: the lane's device (the service's own
        when unsharded), read off its tensors."""
        return self.lead_index.device


def _bucket_scores(b: _Bucket, xs: torch.Tensor,
                   impl: Optional[str]) -> torch.Tensor:
    """``[M, Ppad, L, 1]`` member inputs -> P(stable) ``[M, Ppad]``."""
    logits = ecg_apply_stacked(b.stacked, xs, b.spec, impl=impl)
    return torch.softmax(logits, dim=-1)[..., 1]


def _lead_expand(b: _Bucket, win: torch.Tensor) -> torch.Tensor:
    """On-device lead-gather: the shared ``[Ppad, C, L]`` pack -> the
    bucket's ``[M, Ppad, L, 1]`` view (pure data movement)."""
    return win.index_select(1, b.lead_index).permute(1, 0, 2) \
        .unsqueeze(-1).contiguous()


@dataclasses.dataclass
class _FlushGraph:
    """One captured flush rung: the graph, its static input packs
    (input length -> ``[Ppad, ECG_LEADS, L]``), its static ``[sum M,
    Ppad]`` scores, rows in bucket order, and the kernel launches a
    replay makes (launch counter -> launches)."""
    graph: "torch.cuda.CUDAGraph"
    packs: Dict[int, torch.Tensor]
    scores: torch.Tensor
    launches: Dict["_build.LaunchCount", int]




# representative flush rung for placement-planning cost measurement:
# flushes pad to the pow2 ladder, and per-bucket cost RATIOS at batch 1
# differ from ratios at flush size (fixed per-pass host cost dominates
# small stacked calls), so planning from batch-1 timings skews the plan
PLAN_BATCH = 8

# EWMA weight for per-shard retire-time tracking (O(1) state per
# (bucket, lane) shard; higher = drift shows faster, noisier)
RETIRE_ALPHA = 0.3


@functools.lru_cache(maxsize=None)
def _warmup_pack(L: int, p: int, channels: int = ECG_LEADS
                 ) -> np.ndarray:
    """Shared zero window packs for warm-up, staging and cost
    measurement: every bucket (and every service being staged for a hot
    swap) warms the same (length, flush-size) host buffer."""
    return np.zeros((p, channels, L), np.float32)


def _clock_start(dev: torch.device):
    """Start a shard's retire clock: the host's perf counter on the CPU,
    a CUDA event on the card (read after the flush's sync, so timing a
    shard adds no sync of its own)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev
    return time.perf_counter()


def _clock_stop(dev: torch.device, start):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return start, ev
    return time.perf_counter() - start


def _clock_seconds(mark) -> float:
    if isinstance(mark, tuple):
        start, end = mark
        end.synchronize()               # done already: after the sync
        return start.elapsed_time(end) / 1e3
    return mark


class EnsembleService:
    """Stateless ensemble actors with a bucketed fused dispatch plan.

    ``fused=True`` (default): one stacked pass per architecture bucket
    per flush, micro-batched across patients.  ``fused=False``: the
    one-call-per-member-per-patient loop (the numerical oracle).
    ``dispatch_count`` tallies zoo passes issued by ``predict``/
    ``predict_batch`` — the quantity the serving benchmark tracks per
    query.  Member params are moved to ``device`` (default: the first
    lane's device when ``devices`` is given, else ``cuda:0``).

    ``placement`` (a ``serving.placement.Placement`` whose assignment
    covers every member exactly once) shards the fused plan over
    ``devices``, a list of distinct ``Lane``s (default
    ``device_lanes()``): slot d's members are bucketed on their own and
    held on lane d's device, one stacked pass per (bucket, lane) shard.
    A plan that uses a slot beyond the lanes is refused.  Bucket-aligned
    plans are bitwise equal to the unsharded path; member-level
    assignments change the stacked member-axis sizes and match to the
    float tolerance only.

    ``dispatch_guard`` is the fault-injection seam
    (``control.faults.FaultPlane.guard``): ``None`` by default; when
    set, it is called with the bucket's lane (``None`` for an unsharded
    service's own device) just before each stacked pass of a flush or
    a slot tick, once before the unfused loop, and raising
    ``DeviceLostError`` there is how a device lost mid-flush reaches
    the serving path.  A flush that replays a graph calls it for every
    bucket, in bucket order, before the replay.

    ``graph_flushes`` and ``eager_flushes`` count the fused flushes that
    replayed a captured graph and those that issued the eager loop
    (module docstring).
    """

    def __init__(self, members: Sequence[ZooMember],
                 vitals_model=None, labs_model=None,
                 fused: bool = True, impl: Optional[str] = None,
                 placement: Optional[Placement] = None,
                 marshal: str = "packed",
                 device: DeviceLike = None,
                 devices: Optional[Sequence[Lane]] = None):
        if marshal not in ("packed", "legacy"):
            raise ValueError(f"unknown marshal mode {marshal!r}")
        if placement is not None:
            if not fused:
                raise ValueError("placement requires the fused path")
            placed = sorted(i for slot in placement.assignment
                            for i in slot)
            if placed != list(range(len(members))):
                raise ValueError(
                    f"placement must cover every member exactly once: "
                    f"got {placed} for {len(members)} members")
        self._devices = as_lanes(devices) if devices is not None else None
        if device is None and self._devices:
            device = self._devices[0].device
        self.device = resolve_device(device)
        self.members = [ZooMember(m.spec, map_params(
            m.params, lambda t: t.to(self.device))) for m in members]
        self.vitals_model = vitals_model
        self.labs_model = labs_model
        self.fused = fused
        self.impl = impl
        self.marshal = marshal
        self.placement = placement
        self.dispatch_count = 0
        self.dispatch_guard: Optional[Callable] = None
        # ingest-side accounting: bytes shipped host->device for flush
        # inputs, and host seconds spent building/transferring them
        self.h2d_bytes = 0
        self.marshal_seconds = 0.0
        # live per-shard retire times: (bucket member tuple) -> EWMA of
        # the shard's seconds on the fused flush path (the drift signal
        # HotSwapper.re_place consumes); O(1) state per shard
        self.retire_alpha = RETIRE_ALPHA
        self._shard_ewma: Dict[Tuple[int, ...], float] = {}
        self._count_lock = threading.Lock()    # server workers share us
        self._bucket_cache: Optional[List[_Bucket]] = None
        self.graph_flushes = 0
        self.eager_flushes = 0
        self._graphs: Dict[int, _FlushGraph] = {}    # rung -> its graph
        self._graph_lock = threading.Lock()  # a replay's static buffers
        self._graph_pool = None              # shared by the rungs' graphs
        self._graph_stream = None            # where captures and replays run

    @classmethod
    def for_selector(cls, pool: Sequence[ZooMember],
                     selector: np.ndarray, **kwargs) -> "EnsembleService":
        """Service over the subset of ``pool`` a binary selector picks —
        the control plane's staging constructor (swap.HotSwapper)."""
        idx = np.flatnonzero(np.asarray(selector, bool))
        return cls([pool[i] for i in idx], **kwargs)

    # ------------------------------------------------------------ plan
    @property
    def devices(self) -> List[Lane]:
        """The lanes a placement's slots map onto (``device_lanes()``
        unless the service was given its own)."""
        return self._devices if self._devices is not None \
            else as_lanes(None)

    @property
    def _buckets(self) -> List[_Bucket]:
        """Stacked dispatch plan, built lazily on the first fused flush
        (so measurement-only services never pay the param stacking)."""
        if self._bucket_cache is None:
            with self._count_lock:
                if self._bucket_cache is None:
                    self._bucket_cache = self._build_buckets()
        return self._bucket_cache

    def _build_buckets(self) -> List[_Bucket]:
        specs = [m.spec for m in self.members]
        if self.placement is None:
            groups = [(0, None, list(range(len(specs))))]
        else:
            devs = self.devices
            used = [d for d, slot
                    in enumerate(self.placement.assignment) if slot]
            if used and used[-1] >= len(devs):
                # refuse to fold slots onto fewer lanes: the plan's
                # makespan/imbalance would describe parallelism that
                # does not exist
                raise ValueError(
                    f"placement uses slot {used[-1]} but only "
                    f"{len(devs)} lane(s) are available")
            groups = [(d, devs[d], list(slot))
                      for d, slot in enumerate(self.placement.assignment)
                      if slot]
        out = []
        for slot_idx, lane, mem_idx in groups:
            tdev = self.device if lane is None else lane.device
            for local in bucket_zoo([specs[i] for i in mem_idx]).values():
                idx = [mem_idx[j] for j in local]
                leads = [specs[i].lead for i in idx]
                stacked = stack_members([self.members[i].params
                                         for i in idx])
                if tdev != self.device:
                    stacked = map_params(stacked, lambda t: t.to(tdev))
                out.append(_Bucket(
                    spec=specs[idx[0]], idx=idx, leads=leads,
                    lead_index=torch.tensor(leads, device=tdev),
                    stacked=stacked, device=lane, slot=slot_idx))
        return out

    @property
    def n_buckets(self) -> int:
        """Stacked dispatches per flush: architecture buckets, or
        (bucket, lane) shards when a placement is active."""
        return len(self._buckets)

    def plan_placement(self, n_devices: int,
                       bucket_costs: Optional[Sequence[float]] = None,
                       reps: int = 3,
                       batch: Optional[int] = None,
                       speeds: Optional[Sequence[float]] = None
                       ) -> Placement:
        """LPT plan over measured (or given) per-bucket costs, at BUCKET
        granularity: a stacked bucket is atomic, so the plan never splits
        one stacked pass across lanes.  The returned assignment is in
        member indices, ready for ``EnsembleService(placement=...)``.
        Costs are measured at a representative flush rung (``batch``,
        default ``PLAN_BATCH``); ``speeds`` (one per slot) makes the plan
        heterogeneity-aware (``placement.lpt_placement``)."""
        groups = list(bucket_zoo([m.spec for m in self.members]).values())
        if bucket_costs is None:
            if self.placement is not None:
                raise ValueError("measure bucket costs on an unsharded "
                                 "service (or pass bucket_costs)")
            bucket_costs = self.measured_bucket_costs(
                reps=reps, batch=PLAN_BATCH if batch is None else batch)
        return grouped_lpt_placement(groups, list(bucket_costs),
                                     n_devices, speeds=speeds)

    # ---------------------------------------------------------- warmup
    def _sync(self, devs: Optional[Sequence[torch.device]] = None) -> None:
        """Wait for the card(s): the service's device and every device
        a bucket lives on (or just ``devs``)."""
        if devs is None:
            devs = {self.device} | {b.tdev for b in
                                    (self._bucket_cache or ())}
        for d in set(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _bucket_input(self, b: _Bucket, p: int) -> torch.Tensor:
        """A zero input of ``b`` at flush size ``p`` on its device: the
        shared window pack (packed) or the member-expanded input."""
        L = b.spec.input_len
        if self.marshal == "legacy":
            return torch.zeros((len(b.idx), p, L, 1), device=b.tdev)
        return to_device(_warmup_pack(L, p), b.tdev)

    def _bucket_pass(self, b: _Bucket, x: torch.Tensor) -> torch.Tensor:
        xs = x if self.marshal == "legacy" else _lead_expand(b, x)
        return _bucket_scores(b, xs, self.impl)

    @property
    def _graphable(self) -> bool:
        """Whether a flush may replay a captured graph: the fused,
        packed, unsharded path on a CUDA device."""
        return (self.device.type == "cuda" and self.fused
                and self.marshal == "packed" and self.placement is None)

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4, 8)) -> None:
        """Run every bucket once at each pow2 flush rung (the sizes
        ``predict_batch`` pads to), so the first full-census flush pays
        no one-time cost (the kernel library build, allocator growth)
        on the latency path.  Packed mode shares one zero window pack
        per (input length, device, flush size) across all buckets.
        Where a flush may replay a graph (``_graphable``) the passes run
        on the service's own stream, and each rung not captured yet is
        then captured on it (``_capture``)."""
        if self.fused:
            side = None
            if self._graphable and self._buckets:
                if self._graph_stream is None:
                    self._graph_stream = torch.cuda.Stream(self.device)
                side = self._graph_stream
                side.wait_stream(torch.cuda.current_stream(self.device))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                shared: Dict = {}
                for b in self._buckets:
                    for p in batch_sizes:
                        key = (b.spec.input_len, b.tdev, p)
                        x = shared.get(key)
                        if x is None or self.marshal == "legacy":
                            x = self._bucket_input(b, p)
                            shared[key] = x
                        self._bucket_pass(b, x)
                if side is not None:
                    for p in batch_sizes:
                        self._capture(p, side)
        else:
            for m in self.members:
                self._member_score(m, torch.zeros(
                    (1, m.spec.input_len, 1), device=self.device))
        self._sync()

    def _capture(self, p: int, stream: "torch.cuda.Stream") -> None:
        """Capture rung ``p``'s flush on ``stream``, after a pass there
        has warmed every operation: every bucket's pass over zero
        static packs, in bucket order, and their scores concatenated.
        The rungs of one service share a memory pool: their replays
        never overlap (the service's stream, under the graph lock), and
        a replay's output is cloned before the next replay starts.
        Capture errors only for the capturing thread, so a service can
        capture while another serves (a hot swap's staging).  The
        wrappers' launch counters take the capture's launches as the
        graph's tally, which each replay adds to them."""
        if p in self._graphs:
            return
        buckets = self._buckets
        packs = {L: torch.zeros((p, ECG_LEADS, L), device=self.device)
                 for L in sorted({b.spec.input_len for b in buckets})}
        graph = torch.cuda.CUDAGraph()
        with _build.CAPTURE_LOCK, _build.CaptureLaunches() as launches:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                scores = torch.cat([
                    self._bucket_pass(b, packs[b.spec.input_len])
                    for b in buckets])
        with self._graph_lock:
            self._graphs[p] = _FlushGraph(graph, packs, scores, launches)

    def _member_score(self, m: ZooMember, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(ecg_apply(m.params, x, m.spec,
                                       impl=self.impl), dim=-1)[:, 1]

    def measured_costs(self, reps: int = 3,
                       warmup: int = 1) -> List[float]:
        """Closed-loop per-member seconds/query (the mu measurement).
        Always uses the per-member forward — the composer's latency
        profiler needs individual member costs regardless of fused
        serving.  ``warmup`` untimed calls precede the timed reps."""
        out = []
        for m in self.members:
            x = torch.zeros((1, m.spec.input_len, 1), device=self.device)
            for _ in range(max(1, warmup)):
                self._member_score(m, x)
            self._sync([self.device])
            t0 = time.perf_counter()
            for _ in range(reps):
                self._member_score(m, x)
            self._sync([self.device])
            out.append((time.perf_counter() - t0) / reps)
        return out

    def measured_bucket_costs(self, reps: int = 3, batch: int = 1,
                              warmup: int = 1) -> List[float]:
        """Closed-loop seconds per stacked bucket pass — the cost vector
        the LPT placement planner consumes.  Each bucket is warmed with
        ``warmup`` untimed calls first, so a one-time cost never folds
        into the estimate."""
        out = []
        for b in self._buckets:
            x = self._bucket_input(b, batch)
            for _ in range(max(1, warmup)):
                self._bucket_pass(b, x)
            self._sync([b.tdev])
            t0 = time.perf_counter()
            for _ in range(reps):
                self._bucket_pass(b, x)
            self._sync([b.tdev])
            out.append((time.perf_counter() - t0) / reps)
        return out

    # --------------------------------------------------------- serving
    def predict(self, windows) -> float:
        """windows: {"ecg": [3, L], "vitals": [7, W], "labs": [8]} or a
        ``DeviceWindowRef``.  Returns the bagged P(stable) (Eq. 5)."""
        return self.predict_batch([windows])[0]

    def predict_batch(self, batch) -> List[float]:
        """Micro-batched form of ``predict``: one flush for windows
        from len(batch) patients — host window dicts or
        ``DeviceWindowRef``s (never mixed).  Packed path: ONE
        [Ppad, 3, L] window pack per distinct input length, shipped at
        most once per device, lead-expanded on the device inside each
        bucket's pass; the scores come back with one device->host copy
        per device at the end.  ECG windows shorter than a member's
        input_len are left-zero-padded (the aggregator's zero-fill
        convention)."""
        if not len(batch):
            return []
        if isinstance(batch[0], DeviceWindowRef):
            return self._predict_refs(batch)
        if not self.fused:
            return [self._predict_one_unfused(w) for w in batch]
        if self.marshal == "legacy":
            return self._predict_batch_legacy(batch)

        P = len(batch)
        # pad the micro-batch to the next power of two: per-window
        # forward passes are batch-independent, so zero rows are inert
        Ppad = pow2_rung(P)
        t_marshal = time.perf_counter()
        with _spans.span("flush.marshal"):
            packs: Dict[int, np.ndarray] = {}
            for L in sorted({b.spec.input_len for b in self._buckets}):
                win = np.zeros((Ppad, ECG_LEADS, L), np.float32)
                for p, w in enumerate(batch):
                    clip = np.asarray(w["ecg"], np.float32)[:, -L:]
                    win[p, :, L - clip.shape[-1]:] = clip
                packs[L] = win
            dev_wins, h2d = self._ship_packs(packs)
        marshal_s = time.perf_counter() - t_marshal
        scores = self._flush(dev_wins, P)
        with self._count_lock:
            self.h2d_bytes += h2d
            self.marshal_seconds += marshal_s
        return self._combine(scores, batch)

    def _ship_packs(self, packs: Dict[int, object]
                    ) -> Tuple[Dict, int]:
        """Bring each window pack to every ``torch.device`` a bucket
        lives on, once: a host pack is copied over (its bytes counted
        once a device), a pack already on a device is not copied again
        (lanes on one card share one copy).  Returns
        ({(L, torch.device): tensor}, host->device bytes)."""
        dev_wins: Dict = {}
        h2d = 0
        for b in self._buckets:
            key = (b.spec.input_len, b.tdev)
            if key in dev_wins:
                continue
            win = packs[b.spec.input_len]
            if isinstance(win, np.ndarray):
                dev_wins[key] = to_device(win, b.tdev)
                h2d += win.nbytes
            else:
                dev_wins[key] = win.to(b.tdev)
        return dev_wins, h2d

    def _flush(self, dev_wins: Dict, P: int) -> np.ndarray:
        """Issue one stacked pass per bucket shard against the shipped
        packs (asynchronous on the card), then retire everything with
        one device->host copy of the scores per device.

        A sharded service times each shard for its retire EWMA (their
        readers, re-place and the controller's profile, plan sharded
        deployments only; an unsharded flush takes no clock).  The
        clock starts BEFORE the guard, as the reference's does: an
        injected per-lane stall is device time and must drift that
        shard's EWMA.  The reference times a shard from dispatch to its
        retire in the gather loop (host wall clock); here a shard's
        time runs from just before its guard to the end of its pass —
        the host clock on the CPU, where a pass has finished when its
        call returns, and a pair of CUDA events on the card, read after
        the flush's sync.  Spans: ``flush.dispatch`` with one
        ``flush.bucket`` a pass, then ``flush.gather``.

        At a captured rung the flush replays its graph instead
        (``_replay``)."""
        graph = self._graphs.get(pow2_rung(P)) if self._graphable else None
        if graph is not None:
            return self._replay(graph, dev_wins, P)
        guard = self.dispatch_guard
        buckets = self._buckets
        timed = self.placement is not None
        ys, marks = [], []
        with _spans.span("flush.dispatch"):
            for b in buckets:
                with _spans.span("flush.bucket"):
                    start = _clock_start(b.tdev) if timed else None
                    if guard is not None:
                        guard(b.device)
                    ys.append(self._bucket_pass(
                        b, dev_wins[(b.spec.input_len, b.tdev)]))
                    if timed:
                        marks.append(_clock_stop(b.tdev, start))
            with self._count_lock:
                self.dispatch_count += len(ys)
                self.eager_flushes += 1
        with _spans.span("flush.gather"):
            score_mat = self._retire(buckets, ys, P)
        for b, mark in zip(buckets, marks):
            self._record_retire(b, _clock_seconds(mark))
        return score_mat

    def _replay(self, graph: _FlushGraph, dev_wins: Dict,
                P: int) -> np.ndarray:
        """A flush at a captured rung: every bucket's guard in bucket
        order, then, under the graph lock and on the service's own
        stream, one copy of each pack into the static one, the replay,
        and a clone of the static scores.  That stream waits for the
        caller's, where the packs were written, and the caller's then
        waits for it, whatever stream the caller flushes on; so the
        other worker's next copy into the static buffers is ordered
        after this clone, and the copy to the host waits outside the
        lock.  Each replay adds the graph's launches to the kernels'
        counters.  Spans: ``flush.dispatch`` with one ``flush.replay``
        (the lock, the copies, the replay and the clone), then
        ``flush.gather``, which holds the wait for the card."""
        guard = self.dispatch_guard
        buckets = self._buckets
        with _spans.span("flush.dispatch"):
            if guard is not None:
                for b in buckets:
                    guard(b.device)
            with _spans.span("flush.replay"), self._graph_lock:
                caller = torch.cuda.current_stream(self.device)
                own = self._graph_stream
                own.wait_stream(caller)
                with torch.cuda.stream(own):
                    for L, x in graph.packs.items():
                        x.copy_(dev_wins[(L, self.device)])
                    graph.graph.replay()
                    y = graph.scores[:, :P].clone()
                caller.wait_stream(own)
            for counter, n in graph.launches.items():
                counter.add(n)
            with self._count_lock:
                self.dispatch_count += len(buckets)
                self.graph_flushes += 1
        with _spans.span("flush.gather"):
            score_mat = np.zeros((len(self.members), P))
            self._place(score_mat, buckets, y, P)
        return score_mat

    def _retire(self, buckets: Sequence[_Bucket], ys: List[torch.Tensor],
                P: int) -> np.ndarray:
        """Scores of every shard into the ``[M, P]`` host matrix: ONE
        device->host copy per distinct device (the sync)."""
        score_mat = np.zeros((len(self.members), P))
        by_dev: Dict[torch.device, List] = {}
        for b, y in zip(buckets, ys):
            by_dev.setdefault(b.tdev, []).append((b, y))
        for pairs in by_dev.values():
            self._place(score_mat, [b for b, _ in pairs],
                        torch.cat([y for _, y in pairs]), P)
        return score_mat

    @staticmethod
    def _place(score_mat: np.ndarray, buckets: Sequence[_Bucket],
               y: torch.Tensor, P: int) -> None:
        """Copy one device's ``[sum M, >= P]`` scores, rows in the order
        of ``buckets``, to the host and into their members' rows."""
        host = y[:, :P].cpu().numpy()
        row = 0
        for b in buckets:
            score_mat[b.idx] = host[row:row + len(b.idx)]
            row += len(b.idx)

    # ------------------------------------------- live shard cost drift
    def _record_retire(self, b: _Bucket, dt: float) -> None:
        """Fold one shard's seconds into its EWMA.  A persistently slow
        lane inflates its own shards' EWMAs on every flush, so the
        drift signal converges over repeated flushes."""
        key = tuple(sorted(b.idx))
        with self._count_lock:
            prev = self._shard_ewma.get(key)
            self._shard_ewma[key] = dt if prev is None else (
                self.retire_alpha * dt
                + (1.0 - self.retire_alpha) * prev)

    def shard_cost_snapshot(self) -> Dict[Tuple[int, ...], float]:
        """Live per-shard retire EWMAs, keyed by the shard's sorted
        member-index tuple (stable across re-placements for
        bucket-aligned plans).  Empty until the first fused flush, and
        always for an unsharded service (it takes no clock)."""
        with self._count_lock:
            return dict(self._shard_ewma)

    def live_bucket_costs(self) -> Optional[List[float]]:
        """Measured per-architecture-bucket costs in DEVICE-INDEPENDENT
        work units (retire EWMA x the speed of the slot the bucket
        currently runs on), ordered like ``plan_placement``'s groups — a
        drop-in ``bucket_costs`` vector for re-planning from drift.
        None until every bucket has been observed (never, unsharded), or
        when the active plan is not bucket-aligned."""
        snap = self.shard_cost_snapshot()
        if not snap:
            return None
        groups = list(bucket_zoo([m.spec for m in self.members]).values())
        speed_of = {}
        if self._bucket_cache is not None:
            sp = self.placement.speeds
            for b in self._bucket_cache:
                speed_of[tuple(sorted(b.idx))] = (
                    sp[b.slot] if sp is not None else 1.0)
        out = []
        for g in groups:
            key = tuple(sorted(g))
            dt = snap.get(key)
            if dt is None:
                return None
            out.append(dt * speed_of.get(key, 1.0))
        return out

    def measured_finish_times(self) -> Optional[List[float]]:
        """Live per-slot finish times (seconds): the max retire EWMA
        over the shards of each slot.  None until every shard has been
        observed (never, unsharded).  Idle slots report 0.0, so the
        finish-time imbalance over this vector catches stranded lanes."""
        if self._bucket_cache is None or self.placement is None:
            return None
        snap = self.shard_cost_snapshot()
        fin = [0.0] * self.placement.n_slots
        for b in self._bucket_cache:
            dt = snap.get(tuple(sorted(b.idx)))
            if dt is None:
                return None
            fin[b.slot] = max(fin[b.slot], dt)
        return fin

    def _predict_refs(self, batch: Sequence[DeviceWindowRef]
                      ) -> List[float]:
        """Device-resident flush: the batch's windows already live in a
        ``DeviceIngest`` ring, so the pack is GATHERED on the device
        (``gather_windows`` fuses ring unwrap + zero-fill + batch
        padding) and only the flushed (patient, end, valid) triples
        cross the host boundary — zero sample bytes of H2D.  A sharded
        plan copies the gathered pack to each other device a lane lives
        on, once (none on one card).  Bitwise-identical to the
        host-dict path fed the same windows.  The staleness guard and
        the gather launches run under the ingest lock, so no chunk
        lands between them."""
        if not self.fused:
            return [self._predict_one_unfused(self._ref_windows(r))
                    for r in batch]
        if self.marshal == "legacy":
            raise ValueError("DeviceWindowRef flushes need the packed "
                             "marshal (legacy expects member-expanded "
                             "host inputs)")
        ingest = batch[0].ingest
        if any(r.ingest is not ingest for r in batch):
            raise ValueError("a flush must come from one DeviceIngest")
        P = len(batch)
        Ppad = pow2_rung(P)
        t_marshal = time.perf_counter()
        with _spans.span("flush.marshal"):
            lens = sorted({b.spec.input_len for b in self._buckets})
            patients = [r.patient for r in batch] + [0] * (Ppad - P)
            ends = [r.ends["ecg"] for r in batch] + [0] * (Ppad - P)
            valid = [r.valid["ecg"] for r in batch] + [0] * (Ppad - P)
            with _spans.held(ingest.lock, "flush.marshal.lock"):
                buf = ingest.states["ecg"].buf
                ingest.check_fresh("ecg", batch, max(lens, default=0))
                packs = {L: gather_windows(buf, patients, ends, valid, L,
                                           impl=self.impl) for L in lens}
            h2d = 3 * 4 * Ppad * len(lens)    # the int32 index triples
            dev_wins, _ = self._ship_packs(packs)   # D2D, other devices
        marshal_s = time.perf_counter() - t_marshal
        scores = self._flush(dev_wins, P)
        with self._count_lock:
            self.h2d_bytes += h2d
            self.marshal_seconds += marshal_s
        return self._combine(scores, self._refs_side_batch(batch))

    def _refs_side_batch(self, batch: Sequence[DeviceWindowRef]):
        """CPU-side model inputs for a ref flush: with a vitals model
        attached, read ALL flushed patients' vitals windows back in ONE
        batched gather (index vectors padded to the same pow2 rung as
        the ECG path) and hand ``_combine`` plain dicts.  Without
        CPU-side models the refs pass through and nothing is read back.
        The low-rate ring has its own staleness guard: its small
        capacity is overrun on a different clock than the ECG ring's.
        The span ``flush.side`` holds the lock's and the readback's
        time."""
        if self.vitals_model is None \
                or "vitals" not in batch[0].ingest.states:
            return batch
        ingest = batch[0].ingest
        want = ingest.want["vitals"]
        Ppad = pow2_rung(len(batch))
        pad = [0] * (Ppad - len(batch))
        with _spans.span("flush.side"):
            with _spans.held(ingest.lock, "flush.side.lock"):
                buf = ingest.states["vitals"].buf
                ingest.check_fresh("vitals", batch, want)
                win = gather_windows(
                    buf, [r.patient for r in batch] + pad,
                    [r.ends["vitals"] for r in batch] + pad,
                    [r.valid["vitals"] for r in batch] + pad, want,
                    impl=self.impl)
            win = win.cpu().numpy()
        return [{**r.extra, "vitals": win[p]}
                for p, r in enumerate(batch)]

    def _ref_windows(self, r: DeviceWindowRef) -> Dict[str, np.ndarray]:
        """Materialize a ref as the oracle's host window dict (unfused
        path only — the fused path never reads samples back)."""
        out = dict(r.extra)
        for name in r.ends:
            out[name] = r.host_window(name, impl=self.impl)
        return out

    def _predict_batch_legacy(self, batch) -> List[float]:
        """Pre-refactor hot path: per bucket an [M, Ppad, L, 1] input
        is marshaled by a host (member, patient) double loop and
        shipped whole to the bucket's device — M x L floats per patient
        per bucket.  Kept behind ``marshal="legacy"`` as a second
        equivalence oracle."""
        P = len(batch)
        Ppad = pow2_rung(P)
        ys = []
        h2d = 0
        t_marshal = time.perf_counter()
        guard = self.dispatch_guard
        buckets = self._buckets
        # legacy interleaves marshal + dispatch per bucket; attribute
        # the whole pre-gather segment to marshal
        with _spans.span("flush.marshal"):
            for b in buckets:
                if guard is not None:
                    guard(b.device)
                L = b.spec.input_len
                xs = np.zeros((len(b.idx), Ppad, L, 1), np.float32)
                for j, lead in enumerate(b.leads):
                    for p, w in enumerate(batch):
                        clip = np.asarray(w["ecg"])[lead, -L:]
                        xs[j, p, L - clip.shape[-1]:, 0] = clip
                h2d += xs.nbytes
                ys.append(_bucket_scores(b, to_device(xs, b.tdev),
                                         self.impl))
        marshal_s = time.perf_counter() - t_marshal
        with self._count_lock:
            self.dispatch_count += len(ys)
            self.eager_flushes += 1
            self.h2d_bytes += h2d
            self.marshal_seconds += marshal_s
        with _spans.span("flush.gather"):
            score_mat = self._retire(buckets, ys, P)
        return self._combine(score_mat, batch)

    def _predict_one_unfused(self, windows: Dict[str, np.ndarray]
                             ) -> float:
        ecg = windows.get("ecg")
        if self.dispatch_guard is not None:
            self.dispatch_guard(None)       # unfused runs on our device
        ys = []
        for m in self.members:
            L = m.spec.input_len
            clip = np.asarray(ecg, np.float32)[m.spec.lead, -L:]
            if clip.shape[-1] < L:     # zero-fill short windows (matches
                clip = np.pad(clip, (L - clip.shape[-1], 0))  # aggregator)
            x = to_device(clip[None, :, None], self.device)
            ys.append(self._member_score(m, x))
        score_mat = torch.stack(ys).cpu().numpy().astype(np.float64) \
            if ys else np.zeros((0, 1))
        with self._count_lock:
            self.dispatch_count += len(self.members)
        return self._combine(score_mat, [windows])[0]

    def _side_input(self, item, name: str) -> Optional[np.ndarray]:
        """The CPU-side models' input for one batch item: a window-dict
        key, or — for a ``DeviceWindowRef`` — the labs side channel /
        a lazy readback of the (tiny, low-rate) vitals window."""
        if isinstance(item, DeviceWindowRef):
            if name in item.extra:
                return item.extra[name]
            if name in item.ends:
                return item.host_window(name, impl=self.impl)
            return None
        return item.get(name)

    def _combine(self, score_mat: np.ndarray, batch) -> List[float]:
        """Per-patient Eq. 5 mean over zoo scores + CPU-side models (the
        span ``flush.combine``)."""
        out = []
        with _spans.span("flush.combine"):
            for p, windows in enumerate(batch):
                scores = list(score_mat[:, p]) if len(self.members) else []
                if self.vitals_model is not None:
                    vit = self._side_input(windows, "vitals")
                    if vit is not None:
                        scores.append(float(
                            self.vitals_model.predict_proba(vit[None])[0]))
                if self.labs_model is not None:
                    labs = self._side_input(windows, "labs")
                    if labs is not None:
                        scores.append(float(
                            self.labs_model.predict_proba(labs[None])[0]))
                out.append(float(np.mean(scores)) if scores else 0.5)
        return out


class TierRouter:
    """Routes each query through its acuity tier's service (the data-
    plane face of per-tier degradation ladders).

    ``services`` maps tier -> anything with ``predict``/``predict_batch``.
    Batches must be tier-homogeneous — the tier-keyed batcher upstream
    (``serving.queues.KeyedMicroBatcher``) guarantees that — so one
    flush is always answered by exactly one tier's selector.
    """

    def __init__(self, services: Dict[str, object],
                 default: Optional[str] = None):
        if not services:
            raise ValueError("services must be non-empty")
        self.services = dict(services)
        self.default = default if default is not None \
            else next(iter(self.services))
        if self.default not in self.services:
            raise ValueError(f"default {self.default!r} not in "
                             f"{tuple(self.services)}")

    def service(self, tier: Optional[str] = None):
        return self.services[tier if tier in self.services
                             else self.default]

    def predict(self, windows: Dict[str, np.ndarray],
                tier: Optional[str] = None) -> float:
        return self.service(tier).predict(windows)

    def predict_batch(self, batch: Sequence[Dict[str, np.ndarray]],
                      tier: Optional[str] = None) -> List[float]:
        return self.service(tier).predict_batch(batch)


@dataclasses.dataclass
class ServedQuery:
    patient: int
    t_window: float
    t_done: float
    score: float
    # per-stage service attribution (obs.spans stage keys -> seconds),
    # populated when the pipeline serves under span collection
    stages: Optional[Dict[str, float]] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_window


class StreamingPipeline:
    """Stateful aggregators + the ensemble service, driven by a stream.

    ``device_ingest=True`` replaces the per-sample python tuple buffers
    with ``serving.aggregator.DeviceIngest`` on ``device`` (default
    ``cuda:0``): chunks land in device-resident ring buffers and a
    closed window is served as a ``DeviceWindowRef`` — the ensemble's
    flush gathers the samples on the device.  ``PatientAggregator``
    (the default) is kept as the semantics oracle; the two paths score
    bitwise-identically under an aligned feed.

    With ``tier_of`` (patient -> acuity tier) the service must be
    tier-routing (``TierRouter``): each closed window is answered by the
    patient's CURRENT tier's service.

    ``engine="slots"`` (requires ``device_ingest=True``, untiered, a
    plain fused ``EnsembleService`` on ``device``) switches from
    flush-per-window to the continuous slot engine
    (``serving.slots.SlotEngine``): a closed window UPDATES the bed's
    slot, and every ``tick_seconds`` of logical stream time (default:
    one window) one tick rescores all occupied slots — records are
    emitted per (window, covering tick) with the slot's oracle-exact
    score."""

    def __init__(self, service, n_patients: int,
                 window_seconds: float = float(CLIP_SECONDS),
                 tier_of: Optional[Callable[[int], str]] = None,
                 device_ingest: bool = False,
                 capacity_windows: float = 2.0,
                 trace_stages: bool = False,
                 engine: str = "flush",
                 tick_seconds: Optional[float] = None,
                 device: DeviceLike = None):
        if engine not in ("flush", "slots"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "slots" and not device_ingest:
            raise ValueError('engine="slots" requires device_ingest='
                             "True (slots ARE the device rings)")
        if engine == "slots" and tier_of is not None:
            raise ValueError('engine="slots" is untiered')
        mods = [ModalitySpec("ecg", ECG_HZ, ECG_LEADS),
                ModalitySpec("vitals", VITALS_HZ, 7)]
        self.device = resolve_device(device)
        self.engine = engine
        self.tick_seconds = (tick_seconds if tick_seconds is not None
                             else window_seconds)
        self.slot_engine = None
        self._last_tick_t: Optional[float] = None
        self._pending_close: Dict[int, float] = {}
        self.service = service
        self.tier_of = tier_of
        self.device_ingest: Optional[DeviceIngest] = None
        if device_ingest:
            self.device_ingest = DeviceIngest(
                mods, n_patients, window_seconds,
                capacity_windows=capacity_windows, device=self.device)
            # run the flush gather once at every window length the
            # service can ask for (facades/routers don't expose members
            # — call warm_gather yourself there), and the vitals
            # readback's gather over its (differently shaped) ring
            members = getattr(service, "members", None)
            if members:
                self.device_ingest.warm_gather(
                    tuple(sorted({m.spec.input_len for m in members})))
            self.device_ingest.warm_gather(
                (self.device_ingest.want["vitals"],),
                modality="vitals")
            self.aggs = []
        else:
            self.aggs = [PatientAggregator(mods, window_seconds)
                         for _ in range(n_patients)]
        if engine == "slots":
            from repro_torch.serving.slots import SlotEngine
            self.slot_engine = SlotEngine(service, self.device_ingest)
        self.labs_cache: Dict[int, np.ndarray] = {}
        self.records: List[ServedQuery] = []
        self.trace_stages = trace_stages

    def _close(self, t: float, patient: int):
        """The closed window in whichever representation the ingest
        side keeps: a host window dict, or a DeviceWindowRef."""
        if self.device_ingest is not None:
            extra = {}
            if patient in self.labs_cache:
                extra["labs"] = self.labs_cache[patient]
            return self.device_ingest.close_window(patient, t,
                                                   extra=extra)
        windows = self.aggs[patient].pop_window(t)
        if patient in self.labs_cache:
            windows["labs"] = self.labs_cache[patient]
        return windows

    def feed(self, t: float, patient: int, modality: str,
             samples: np.ndarray) -> Optional[ServedQuery]:
        if modality == "labs":
            self.labs_cache[patient] = np.asarray(samples)
            return None
        if self.device_ingest is not None:
            self.device_ingest.ingest(t, patient, modality, samples)
            if not self.device_ingest.window_ready(patient, t):
                return self._maybe_tick(t, patient) \
                    if self.engine == "slots" else None
        else:
            agg = self.aggs[patient]
            agg.ingest(t, modality, samples)
            if not agg.window_ready(t):
                return None
        windows = self._close(t, patient)
        if self.engine == "slots":
            # the closed window updates the bed's slot; scoring happens
            # at the next tick boundary of LOGICAL stream time, covering
            # every slot that closed a window since the last tick
            self.slot_engine.update(windows)
            self._pending_close[patient] = t
            return self._maybe_tick(t, patient)
        t0 = time.perf_counter()
        stages: Optional[Dict[str, float]] = None
        if self.trace_stages:
            with _spans.collect() as tree:
                score = self._serve(windows, patient)
            stages = dict(tree.stages)
        else:
            score = self._serve(windows, patient)
        wall = time.perf_counter() - t0
        rec = ServedQuery(patient=patient, t_window=t, t_done=t + wall,
                          score=score, stages=stages)
        self.records.append(rec)
        return rec

    def _serve(self, windows, patient: int) -> float:
        if self.tier_of is not None:
            return self.service.predict(windows, self.tier_of(patient))
        return self.service.predict(windows)

    def _maybe_tick(self, t: float,
                    patient: Optional[int] = None
                    ) -> Optional[ServedQuery]:
        """Fire a slot tick when a tick interval of logical time has
        passed and windows are pending; emit one ``ServedQuery`` per
        pending closed window the tick covered.  Returns ``patient``'s
        record when this tick scored it."""
        if self._last_tick_t is None:
            self._last_tick_t = t
        if t - self._last_tick_t < self.tick_seconds \
                or not self._pending_close:
            return None
        return self.tick_now(t, patient)

    def tick_now(self, t: float,
                 patient: Optional[int] = None) -> Optional[ServedQuery]:
        """Force a slot tick at logical time ``t`` (drain helper: score
        whatever closed windows are still pending)."""
        eng = self.slot_engine
        if eng is None:
            raise ValueError("tick_now needs engine='slots'")
        t0 = time.perf_counter()
        report = eng.tick()
        wall = time.perf_counter() - t0
        self._last_tick_t = t
        out = None
        for s in map(int, report.scored):
            tw = self._pending_close.pop(s, None)
            if tw is None:
                continue        # rescored slot with no new window
            rec = ServedQuery(patient=s, t_window=tw, t_done=t + wall,
                              score=eng.read(s))
            self.records.append(rec)
            if s == patient:
                out = rec
        return out

    def latencies(self) -> np.ndarray:
        return np.asarray([r.latency for r in self.records])

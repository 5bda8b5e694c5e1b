"""The served ensemble pipeline (Fig. 4): HTTP-ingest stand-in ->
stateful aggregators -> ensemble query -> bagging combine.  The port of
``repro/serving/pipeline.py`` (flush engine, one device).

``EnsembleService`` runs the selected ECG zoo members on its device
(default ``cuda:0``) plus the CPU-side vitals/labs models;
``StreamingPipeline`` drives it from per-patient multi-modal streams and
records end-to-end wall-clock latencies.

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

``impl`` (``None``, ``"torch"`` or ``"cuda"``, see ``kernels.ops``)
selects the kernels for every conv and gather of the service; ``None``
picks by device.  Multi-device placement (``placement=``) is a later
slice of the port.  The continuous slot engine (``serving.slots``)
reuses this module's bucket passes (``StreamingPipeline(engine=
"slots")``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.ecg_zoo import (CLIP_SECONDS, ECG_HZ, ECG_LEADS,
                                         EcgModelSpec, VITALS_HZ,
                                         bucket_zoo)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.ensemble_parallel import stack_members
from repro_torch.models.ecg_resnext import (ecg_apply, ecg_apply_stacked,
                                            map_params)
from repro_torch.obs import spans as _spans
from repro_torch.serving.aggregator import (DeviceIngest, DeviceWindowRef,
                                            ModalitySpec,
                                            PatientAggregator,
                                            gather_windows, pow2_rung,
                                            to_device)


@dataclasses.dataclass
class ZooMember:
    spec: EcgModelSpec
    params: Dict


@dataclasses.dataclass
class _Bucket:
    """One stacked-execution group: structurally identical members."""
    spec: EcgModelSpec            # shape-defining representative
    idx: List[int]                # member indices into self.members
    leads: List[int]              # per stacked member, the lead it reads
    lead_index: torch.Tensor      # the same leads, on the device
    stacked: Dict                 # stack_members() tree, leading axis M


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


class EnsembleService:
    """Stateless ensemble actors with a bucketed fused dispatch plan.

    ``fused=True`` (default): one stacked pass per architecture bucket
    per flush, micro-batched across patients.  ``fused=False``: the
    one-call-per-member-per-patient loop (the numerical oracle).
    ``dispatch_count`` tallies zoo passes issued by ``predict``/
    ``predict_batch`` — the quantity the serving benchmark tracks per
    query.  Member params are moved to ``device`` (default ``cuda:0``).

    ``dispatch_guard`` is the fault-injection seam
    (``control.faults.FaultPlane.guard``): ``None`` by default; when
    set, it is called with the bucket's device (``None`` for the
    service's own device) just before each stacked pass of a flush or
    a slot tick, once before the unfused loop, and raising
    ``DeviceLostError`` there is how a device lost mid-flush reaches
    the serving path.
    """

    def __init__(self, members: Sequence[ZooMember],
                 vitals_model=None, labs_model=None,
                 fused: bool = True, impl: Optional[str] = None,
                 placement=None, marshal: str = "packed",
                 device: DeviceLike = None):
        if placement is not None:
            raise NotImplementedError(
                "placement= (sharded multi-device serving) comes with the "
                "placement slice of the port (serving/placement.py)")
        if marshal not in ("packed", "legacy"):
            raise ValueError(f"unknown marshal mode {marshal!r}")
        self.device = resolve_device(device)
        self.members = [ZooMember(m.spec, map_params(
            m.params, lambda t: t.to(self.device))) for m in members]
        self.vitals_model = vitals_model
        self.labs_model = labs_model
        self.fused = fused
        self.impl = impl
        self.marshal = marshal
        self.dispatch_count = 0
        self.dispatch_guard: Optional[Callable] = None
        # ingest-side accounting: bytes shipped host->device for flush
        # inputs, and host seconds spent building/transferring them
        self.h2d_bytes = 0
        self.marshal_seconds = 0.0
        self._count_lock = threading.Lock()    # server workers share us
        self._bucket_cache: Optional[List[_Bucket]] = None

    # ------------------------------------------------------------ plan
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
        out = []
        for idx in bucket_zoo(specs).values():
            leads = [specs[i].lead for i in idx]
            out.append(_Bucket(
                spec=specs[idx[0]], idx=idx, leads=leads,
                lead_index=torch.tensor(leads, device=self.device),
                stacked=stack_members([self.members[i].params
                                       for i in idx])))
        return out

    @property
    def n_buckets(self) -> int:
        """Stacked dispatches per flush."""
        return len(self._buckets)

    # ---------------------------------------------------------- warmup
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4, 8)) -> None:
        """Run every bucket once at each pow2 flush rung (the sizes
        ``predict_batch`` pads to), so the first full-census flush pays
        no one-time cost (the kernel library build, allocator growth)
        on the latency path."""
        if self.fused:
            for b in self._buckets:
                for p in batch_sizes:
                    L = b.spec.input_len
                    if self.marshal == "legacy":
                        xs = torch.zeros((len(b.idx), p, L, 1),
                                         device=self.device)
                    else:
                        xs = _lead_expand(b, torch.zeros(
                            (p, ECG_LEADS, L), device=self.device))
                    _bucket_scores(b, xs, self.impl)
        else:
            for m in self.members:
                self._member_score(m, torch.zeros(
                    (1, m.spec.input_len, 1), device=self.device))
        self._sync()

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
            self._sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                self._member_score(m, x)
            self._sync()
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
        [Ppad, 3, L] window pack per distinct input length, shipped once,
        lead-expanded on the device inside each bucket's pass; the
        scores come back with a single device->host copy at the end.
        ECG windows shorter than a member's input_len are left-zero-
        padded (the aggregator's zero-fill convention)."""
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
        packs: Dict[int, torch.Tensor] = {}
        h2d = 0
        for L in sorted({b.spec.input_len for b in self._buckets}):
            win = np.zeros((Ppad, ECG_LEADS, L), np.float32)
            for p, w in enumerate(batch):
                clip = np.asarray(w["ecg"], np.float32)[:, -L:]
                win[p, :, L - clip.shape[-1]:] = clip
            packs[L] = to_device(win, self.device)
            h2d += win.nbytes
        marshal_s = time.perf_counter() - t_marshal
        _spans.note("marshal", marshal_s)
        scores = self._flush(packs, P)
        with self._count_lock:
            self.h2d_bytes += h2d
            self.marshal_seconds += marshal_s
        return self._combine(scores, batch)

    def _flush(self, packs: Dict[int, torch.Tensor], P: int) -> np.ndarray:
        """Issue one stacked pass per bucket against the shipped packs
        (asynchronous on the card), then retire everything with ONE
        device->host copy of the concatenated scores."""
        t_dispatch = time.perf_counter()
        guard = self.dispatch_guard
        ys = []
        for b in self._buckets:
            if guard is not None:
                guard(None)
            ys.append(_bucket_scores(
                b, _lead_expand(b, packs[b.spec.input_len]), self.impl))
        with self._count_lock:
            self.dispatch_count += len(ys)
        t_gather = time.perf_counter()
        _spans.note("dispatch", t_gather - t_dispatch)
        return self._retire(ys, P, t_gather)

    def _retire(self, ys: List[torch.Tensor], P: int,
                t_gather: float) -> np.ndarray:
        score_mat = np.zeros((len(self.members), P))
        if ys:                                 # no zoo: CPU models only
            host = torch.cat(ys)[:, :P].cpu().numpy()   # the one sync
            row = 0
            for b in self._buckets:
                score_mat[b.idx] = host[row:row + len(b.idx)]
                row += len(b.idx)
        _spans.note("gather", time.perf_counter() - t_gather)
        return score_mat

    def _predict_refs(self, batch: Sequence[DeviceWindowRef]
                      ) -> List[float]:
        """Device-resident flush: the batch's windows already live in a
        ``DeviceIngest`` ring, so the pack is GATHERED on the device
        (``gather_windows`` fuses ring unwrap + zero-fill + batch
        padding) and only the flushed (patient, end, valid) int32
        triples cross the host boundary — zero sample bytes of H2D.
        Bitwise-identical to the host-dict path fed the same windows.
        The staleness guard and the gather launches run under the
        ingest lock, so no chunk lands between them."""
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
        lens = sorted({b.spec.input_len for b in self._buckets})
        patients = [r.patient for r in batch] + [0] * (Ppad - P)
        ends = [r.ends["ecg"] for r in batch] + [0] * (Ppad - P)
        valid = [r.valid["ecg"] for r in batch] + [0] * (Ppad - P)
        with ingest.lock:
            buf = ingest.states["ecg"].buf
            ingest.check_fresh("ecg", batch, max(lens, default=0))
            packs = {L: gather_windows(buf, patients, ends, valid, L,
                                       impl=self.impl) for L in lens}
        h2d = 3 * 4 * Ppad * len(lens)        # the int32 index triples
        marshal_s = time.perf_counter() - t_marshal
        _spans.note("marshal", marshal_s)
        scores = self._flush(packs, P)
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
        capacity is overrun on a different clock than the ECG ring's."""
        if self.vitals_model is None \
                or "vitals" not in batch[0].ingest.states:
            return batch
        ingest = batch[0].ingest
        want = ingest.want["vitals"]
        Ppad = pow2_rung(len(batch))
        pad = [0] * (Ppad - len(batch))
        with ingest.lock:
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
        shipped whole — M x L floats per patient per bucket.  Kept
        behind ``marshal="legacy"`` as a second equivalence oracle."""
        P = len(batch)
        Ppad = pow2_rung(P)
        ys = []
        h2d = 0
        t_marshal = time.perf_counter()
        guard = self.dispatch_guard
        for b in self._buckets:
            if guard is not None:
                guard(None)
            L = b.spec.input_len
            xs = np.zeros((len(b.idx), Ppad, L, 1), np.float32)
            for j, lead in enumerate(b.leads):
                for p, w in enumerate(batch):
                    clip = np.asarray(w["ecg"])[lead, -L:]
                    xs[j, p, L - clip.shape[-1]:, 0] = clip
            h2d += xs.nbytes
            ys.append(_bucket_scores(b, to_device(xs, self.device),
                                     self.impl))
        marshal_s = time.perf_counter() - t_marshal
        # legacy interleaves marshal + dispatch per bucket; attribute
        # the whole pre-gather segment to marshal
        _spans.note("marshal", marshal_s)
        with self._count_lock:
            self.dispatch_count += len(ys)
            self.h2d_bytes += h2d
            self.marshal_seconds += marshal_s
        return self._combine(self._retire(ys, P, time.perf_counter()),
                             batch)

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
        """Per-patient Eq. 5 mean over zoo scores + CPU-side models."""
        out = []
        for p, windows in enumerate(batch):
            scores = list(score_mat[:, p]) if len(self.members) else []
            if self.vitals_model is not None:
                vit = self._side_input(windows, "vitals")
                if vit is not None:
                    scores.append(float(self.vitals_model.predict_proba(
                        vit[None])[0]))
            if self.labs_model is not None:
                labs = self._side_input(windows, "labs")
                if labs is not None:
                    scores.append(float(self.labs_model.predict_proba(
                        labs[None])[0]))
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
            with _spans.collect() as acc:
                score = self._serve(windows, patient)
            stages = dict(acc)
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

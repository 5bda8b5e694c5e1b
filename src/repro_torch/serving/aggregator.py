"""Stateful data aggregators (§3.4, Fig. 4): the port of
``repro/serving/aggregator.py``.

Multi-rate, multi-modal sensory streams are buffered per patient so the
ensemble always sees a synchronized observation window Delta-T across all
sensors.  Two implementations share semantics:

* ``PatientAggregator`` — plain-python actor, kept as the semantics
  ORACLE (numpy only, carried over unchanged).
* ``AggState`` ring buffers — one ``[n_patients, channels, capacity]``
  tensor per modality on the serving device.  ``DeviceIngest`` wraps
  them into the pipeline's device-resident ingest stage: chunks land
  via ``ingest_chunk`` and a closed observation window is handed to the
  ensemble as a ``DeviceWindowRef`` — a few host integers per modality,
  NO host-side sample marshaling.  The flush side
  (``EnsembleService.predict_batch``) gathers the referenced windows
  straight out of the ring with ``gather_windows`` (the CUDA
  ``window_gather`` kernel on the card).

Ring writes are IN PLACE (the JAX package replaces the whole ring per
chunk because its scatter cannot donate its input).  That makes the
flush's staleness guard and its gather a check-then-act against
ingest: a chunk written between the guard and the gather could tear a
window the guard has just passed.  ``DeviceIngest.lock`` closes that
window — ``ingest`` holds it around the ring write and the ``fed``
update, and every reader (the flush, ``host_window``, the vitals
readback) holds it around its guard and its gather launch.  On the
card both the ring write and the gather are queued on the device's
current stream, so a write queued after the lock is released runs
after the gather it waited for.

The JAX package pads every chunk to a pow2 ladder (``chunk_rung``) so
its compiled ingest step has few shapes; PyTorch runs eagerly, so
``ingest_chunk`` writes the chunk as it is.  ``pow2_rung`` still sets
the ring capacities and the flush padding.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import spans as _spans


# ------------------------------------------------- actor implementation
@dataclasses.dataclass
class ModalitySpec:
    name: str
    rate_hz: float                 # nominal sampling rate
    channels: int


class PatientAggregator:
    """Buffers per-modality samples; emits aligned windows of Delta-T."""

    def __init__(self, modalities: List[ModalitySpec],
                 window_seconds: float):
        self.modalities = {m.name: m for m in modalities}
        self.window = window_seconds
        self.buffers: Dict[str, List[Tuple[float, np.ndarray]]] = {
            m.name: [] for m in modalities}
        self.window_start: Optional[float] = None

    def ingest(self, t: float, modality: str, samples: np.ndarray) -> None:
        if self.window_start is None:
            self.window_start = t
        self.buffers[modality].append((t, np.asarray(samples)))

    def window_ready(self, now: float) -> bool:
        return (self.window_start is not None
                and now - self.window_start >= self.window)

    def pop_window(self, now: float) -> Dict[str, np.ndarray]:
        """Returns {modality: [channels, n_samples]} for the last window,
        dropping data older than the window (noisy-environment tolerant:
        missing samples are zero-filled to the nominal count)."""
        out = {}
        t0 = now - self.window
        for name, spec in self.modalities.items():
            want = max(1, int(round(spec.rate_hz * self.window)))
            rows = [s for (t, s) in self.buffers[name] if t >= t0]
            if rows:
                arr = np.concatenate([np.atleast_2d(r) for r in rows],
                                     axis=-1)[:, -want:]
            else:
                arr = np.zeros((spec.channels, 0), np.float32)
            if arr.shape[-1] < want:             # sensor fell off: pad
                pad = np.zeros((spec.channels, want - arr.shape[-1]),
                               np.float32)
                arr = np.concatenate([pad, arr], axis=-1)
            out[name] = arr.astype(np.float32)
            self.buffers[name] = [(t, s) for (t, s) in self.buffers[name]
                                  if t >= t0]
        self.window_start = now
        return out


# ------------------------------------------------------ ring buffers
class AggState(NamedTuple):
    """One modality's ring buffer for all patients, on one device.
    The tensors are updated in place by ``ingest_chunk``."""
    buf: torch.Tensor          # [n_patients, channels, capacity] f32
    write_idx: torch.Tensor    # [n_patients] int32
    total: torch.Tensor        # [n_patients] int32  samples ever written


def agg_init(n_patients: int, channels: int, capacity: int,
             device: DeviceLike = None) -> AggState:
    dev = resolve_device(device)
    return AggState(
        buf=torch.zeros((n_patients, channels, capacity),
                        dtype=torch.float32, device=dev),
        write_idx=torch.zeros(n_patients, dtype=torch.int32, device=dev),
        total=torch.zeros(n_patients, dtype=torch.int32, device=dev))


def ring_wrap(cap: int) -> int:
    """Wrap modulus for ``write_idx``: the largest multiple of ``cap``
    not exceeding 2**30.  Ring positions are ``write_idx % cap``, so the
    wrap point MUST be a multiple of ``cap`` (a plain 2**30 shears the
    ring for any capacity that does not divide it)."""
    return max(1, (1 << 30) // cap) * cap


def pow2_rung(n: int) -> int:
    """Next power of two >= ``n`` (min 1): the ladder shared by flush
    batch padding and ring capacities."""
    return 1 << (max(1, int(n)) - 1).bit_length()


def chunk_rung(k: int) -> int:
    """The reference's chunk-size ladder (``pow2_rung``); here it only
    sizes ring capacities, since eager ingest needs no static shapes."""
    return pow2_rung(k)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  On the card the copy goes
    through pinned memory and does not wait for the stream, so ingest
    never blocks behind a running flush."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def ingest_chunk(state: AggState, patient: int,
                 samples: np.ndarray) -> AggState:
    """Append ``samples`` ``[channels, k]`` to ``patient``'s ring, in
    place (ring semantics: the oldest samples are overwritten).
    Returns ``state``.  Bitwise the reference's ``ingest_chunk``."""
    samples = np.atleast_2d(np.asarray(samples, np.float32))
    k = samples.shape[-1]
    cap = state.buf.shape[-1]
    if k > cap:
        raise ValueError(f"chunk of {k} samples exceeds ring capacity "
                         f"{cap}")
    if not 0 <= patient < state.buf.shape[0]:
        raise IndexError(f"patient {patient} outside the ring's "
                         f"{state.buf.shape[0]} rows")
    dev = state.buf.device
    pos = torch.remainder(state.write_idx[patient].long()
                          + torch.arange(k, device=dev), cap)
    state.buf[patient].index_copy_(1, pos, to_device(samples, dev))
    state.write_idx[patient] = torch.remainder(
        state.write_idx[patient] + k, ring_wrap(cap))
    state.total[patient] += k
    return state


def read_window(state: AggState, patient: int,
                want: int) -> torch.Tensor:
    """Last ``want`` samples, oldest first: ``[channels, want]``."""
    cap = state.buf.shape[-1]
    idx = torch.remainder(state.write_idx[patient].long() - want
                          + torch.arange(want, device=state.buf.device),
                          cap)
    return state.buf[patient][:, idx]


def gather_windows(buf: torch.Tensor, patients: Sequence[int],
                   ends: Sequence[int], valid: Sequence[int],
                   want: int, impl: Optional[str] = None
                   ) -> torch.Tensor:
    """One-launch flush gather: the last ``want`` samples for each
    flushed patient, ``[P, channels, want]`` oldest-first, with
    left-zero-fill fused in (``valid[i] < want`` rows) and pow2 batch
    padding (``valid == 0`` rows all-zero).  ``ends`` are sample counts
    at window close (any integers — reduced mod capacity here).  The
    three index vectors are host integers: they are range-checked here
    and cross to the device as ONE ``[3, P]`` int32 copy.  Pure data
    movement: bitwise-identical to the host-marshaled pack."""
    N, _, cap = buf.shape
    pts = np.asarray(patients, np.int64)
    if pts.size and (pts.min() < 0 or pts.max() >= N):
        raise IndexError(f"patients {pts.tolist()} outside [0, {N})")
    idx = np.stack([pts, np.mod(np.asarray(ends, np.int64), cap),
                    np.asarray(valid, np.int64)]).astype(np.int32)
    t = to_device(idx, buf.device)
    return ops.window_gather(buf, t[0], t[1], t[2], want, impl=impl)


# ----------------------------------------- device-resident ingest stage
class DeviceWindowRef(NamedTuple):
    """A closed observation window that LIVES in a ``DeviceIngest``
    ring: per modality just ``(end, valid)`` sample counts — the flush
    gathers the samples on device, so handing a window to the server
    costs a few host integers instead of a [channels, want] copy.
    ``extra`` carries host-side side-channel inputs (labs vector)."""
    ingest: "DeviceIngest"
    patient: int
    ends: Dict[str, int]
    valid: Dict[str, int]
    extra: Dict[str, np.ndarray]

    def host_window(self, modality: str,
                    impl: Optional[str] = None) -> np.ndarray:
        """Read this window back as the oracle's [channels, want] array
        (CPU-side models / the unfused oracle; NOT the fused hot path).
        Staleness-guarded like the fused flush."""
        di = self.ingest
        want = di.want[modality]
        with di.lock:
            buf = di.states[modality].buf
            di.check_fresh(modality, [self], want)
            win = gather_windows(buf, [self.patient],
                                 [self.ends[modality]],
                                 [self.valid[modality]], want,
                                 impl=impl)
        return win[0].cpu().numpy()


class DeviceIngest:
    """Device-resident multi-patient ingest: one ``AggState`` ring per
    modality on ``device`` (default ``cuda:0``), written in place.

    Window accounting stays on the host as plain integers (samples fed
    per patient, high-water mark at the last window close); the samples
    themselves never leave the device.  ``close_window`` emits a
    ``DeviceWindowRef`` whose ``valid`` is the number of samples that
    arrived inside the window (clamped to the nominal count), which is
    exactly the ``PatientAggregator`` zero-fill contract: fewer samples
    -> left-zero-fill, more -> keep the last nominal-count many.

    ``capacity_windows`` rings hold that many windows of slack, so a
    ref enqueued behind a busy server stays readable while the next
    window's samples stream in underneath it.

    Concurrency: ``lock`` serialises ring writes (with their ``fed``
    update), growth, and every reader's staleness guard plus gather
    launch (module docstring).

    ``tracer`` (an ``obs.spans.SpanRecorder``): when set, each
    ``ingest`` call is a ``holmes.ingest`` span tree, its thread CPU
    time beside its wall time, with a ``holmes.ingest.lock`` child for
    acquiring ``lock``, handed to ``tracer.record_ingest``.  Without
    one the call pays one attribute test.
    """

    def __init__(self, modalities: List[ModalitySpec],
                 n_patients: int, window_seconds: float,
                 capacity_windows: float = 2.0,
                 device: DeviceLike = None,
                 tracer: Optional["_spans.SpanRecorder"] = None):
        self.device = resolve_device(device)
        self.tracer = tracer
        self.lock = threading.Lock()
        self.modalities = {m.name: m for m in modalities}
        self.window = window_seconds
        self.n_patients = n_patients
        self.states: Dict[str, AggState] = {}
        self.want: Dict[str, int] = {}
        self.fed: Dict[str, np.ndarray] = {}
        self.mark: Dict[str, np.ndarray] = {}
        for m in modalities:
            want = max(1, int(round(m.rate_hz * window_seconds)))
            cap = chunk_rung(max(2, int(np.ceil(
                capacity_windows * want))))          # pow2: wrap-exact
            self.states[m.name] = agg_init(n_patients, m.channels, cap,
                                           self.device)
            self.want[m.name] = want
            self.fed[m.name] = np.zeros(n_patients, np.int64)
            self.mark[m.name] = np.zeros(n_patients, np.int64)
        self.window_start: List[Optional[float]] = [None] * n_patients

    def grow(self, n_patients: int) -> None:
        """Grow the census to ``n_patients`` ring rows (no-op when
        already large enough).  Each ring is replaced by a zero-padded
        copy along the patient axis under ``lock``; existing rows keep
        their samples and window accounting bitwise, new rows start
        empty."""
        with self.lock:
            if n_patients <= self.n_patients:
                return
            add = n_patients - self.n_patients
            for name, st in self.states.items():
                self.states[name] = AggState(
                    buf=torch.cat([st.buf, st.buf.new_zeros(
                        (add,) + tuple(st.buf.shape[1:]))]),
                    write_idx=torch.cat([st.write_idx,
                                         st.write_idx.new_zeros(add)]),
                    total=torch.cat([st.total, st.total.new_zeros(add)]))
                self.fed[name] = np.pad(self.fed[name], (0, add))
                self.mark[name] = np.pad(self.mark[name], (0, add))
            self.window_start.extend([None] * add)
            self.n_patients = n_patients

    def ingest(self, t: float, patient: int, modality: str,
               samples: np.ndarray) -> None:
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        if self.tracer is None:
            with self.lock:
                self._write(t, patient, modality, samples)
            return
        with _spans.collect("ingest") as tree:
            with _spans.held(self.lock, "ingest.lock"):
                self._write(t, patient, modality, samples)
        self.tracer.record_ingest(tree)

    def _write(self, t: float, patient: int, modality: str,
               samples: np.ndarray) -> None:
        """The ring write and its accounting (call under ``lock``)."""
        ingest_chunk(self.states[modality], patient, samples)
        self.fed[modality][patient] += samples.shape[-1]
        if self.window_start[patient] is None:
            self.window_start[patient] = t

    def check_fresh(self, modality: str, refs: Sequence[DeviceWindowRef],
                    span: int) -> None:
        """Staleness guard (call under ``lock``): a ref enqueued behind
        a long stall can be OUTLIVED by the ring — newer samples
        overwrite its window.  The oldest position a gather of ``span``
        samples will read and keep is ``end - min(valid, span)``; if
        ingest has advanced more than ``cap`` past it, serving would
        silently score the wrong window's data, so raise instead (the
        server's safe-batch wrapper turns that into a NaN score for the
        stale query only).  Two host integers per ref."""
        cap = self.states[modality].buf.shape[-1]
        fed = self.fed[modality]
        for r in refs:
            oldest = r.ends[modality] - min(r.valid[modality], span)
            if int(fed[r.patient]) - oldest > cap:
                raise ValueError(
                    f"stale DeviceWindowRef for patient {r.patient}: "
                    f"the {modality} ring (capacity {cap}) has "
                    f"overwritten its window; flush sooner or raise "
                    f"capacity_windows")

    def window_ready(self, patient: int, now: float) -> bool:
        ws = self.window_start[patient]
        return ws is not None and now - ws >= self.window

    def close_window(self, patient: int, now: float,
                     extra: Optional[Dict[str, np.ndarray]] = None
                     ) -> DeviceWindowRef:
        """Close the patient's window: snapshot (end, valid) counts per
        modality, advance the high-water mark, and return the ref.  The
        samples stay put — the flush gathers them on device."""
        ends, valid = {}, {}
        with self.lock:
            for name in self.modalities:
                end = int(self.fed[name][patient])
                ends[name] = end
                valid[name] = min(end - int(self.mark[name][patient]),
                                  self.want[name])
                self.mark[name][patient] = end
            self.window_start[patient] = now
        return DeviceWindowRef(ingest=self, patient=patient, ends=ends,
                               valid=valid, extra=dict(extra or {}))

    def headroom(self, patient: int,
                 modality: Optional[str] = None) -> float:
        """Slack left before a ref closed at the CURRENT mark would be
        overwritten in a ring (conservatively assuming the ref needs a
        full ``want``-sample window): the ingest side's backpressure
        signal.  With a ``modality``: that ring's headroom in samples.
        With ``None``: the minimum across modalities in WINDOW units,
        so the differently-clocked rings are comparable."""
        if modality is not None:
            cap = int(self.states[modality].buf.shape[-1])
            mark = int(self.mark[modality][patient])
            fed = int(self.fed[modality][patient])
            oldest = max(0, mark - self.want[modality])
            return cap - (fed - oldest)
        return min(self.headroom(patient, m) / self.want[m]
                   for m in self.modalities)

    def headroom_by_modality(self, patient: int) -> Dict[str, float]:
        """Per-ring headroom breakdown in samples."""
        return {m: self.headroom(patient, m) for m in self.modalities}

    def warm_gather(self, lens: Tuple[int, ...],
                    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8),
                    modality: str = "ecg") -> None:
        """Run the flush gather once at every (window length, pow2 flush
        size) the service will hit, off the latency path (on the card
        the first launch builds the kernel library)."""
        buf = self.states[modality].buf
        for L in lens:
            for p in batch_sizes:
                z = [0] * p
                gather_windows(buf, z, z, z, L)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

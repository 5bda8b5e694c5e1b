"""Open-loop ICU census traffic from a mix file and a seed.

A census is ``beds`` beds.  Every bed sends a ``chunk_seconds`` chunk of
each modality once a chunk period at its own chunk phase, and closes one
window every ``window_seconds`` at its own close phase.  The set of phases comes from the mix's fixed
``phase_set_seed``; the run's seed only decides which bed gets which
phase and what the chunks hold, so every seed offers the same arrivals.
With ``aligned`` the beds of each unit of ``unit_beds`` (the last one
may be partial) share one chunk phase and one close phase
(clock-aligned monitors: a unit's windows close at one instant).

Chunk data comes from a pool made from the seed before any traffic; a
bed's k-th chunk is pool row ``(offset[bed] + k) % pool_chunks``, its
j-th close carries labs row ``(labs_offset[bed] + j) % pool_chunks``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterator, List, Tuple

import numpy as np

CHUNK, CLOSE = 0, 1


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


@dataclasses.dataclass
class Schedule:
    period: float              # seconds between a bed's window closes
    chunk_period: float
    chunk_phase: np.ndarray    # [beds]
    close_phase: np.ndarray    # [beds]
    offset: np.ndarray         # [beds] pool row of the bed's chunk 0
    labs_offset: np.ndarray    # [beds]

    @property
    def n_beds(self) -> int:
        return len(self.close_phase)

    def events(self) -> Iterator[Tuple[float, int, int]]:
        """``(t, kind, bed)`` in time order, for ever; a chunk before a
        close at the same instant, then by bed."""
        heap = [(float(p), CHUNK, b) for b, p in enumerate(self.chunk_phase)]
        heap += [(float(p), CLOSE, b) for b, p in enumerate(self.close_phase)]
        heapq.heapify(heap)
        k = np.zeros(self.n_beds, np.int64)
        j = np.zeros(self.n_beds, np.int64)
        while True:
            t, kind, b = heapq.heappop(heap)
            yield t, kind, b
            if kind == CHUNK:
                k[b] += 1
                nxt = float(self.chunk_phase[b]) + int(k[b]) * self.chunk_period
            else:
                j[b] += 1
                nxt = float(self.close_phase[b]) + int(j[b]) * self.period
            heapq.heappush(heap, (nxt, kind, b))


def make_schedule(traffic: Dict, config: Dict, seed: int,
                  beds: int = None) -> Schedule:
    n = int(traffic["beds"] if beds is None else beds)
    period = float(config["window_seconds"])
    cper = float(traffic["chunk_seconds"])
    fixed = np.random.default_rng(int(traffic["phase_set_seed"]))
    if traffic["aligned"]:
        unit = np.arange(n) // int(traffic["unit_beds"])
        units = int(unit[-1]) + 1
        close = fixed.uniform(0.0, period, units)[unit]
        chunk = fixed.uniform(0.0, cper, units)[unit]
    else:
        close = fixed.uniform(0.0, period, n)
        chunk = fixed.uniform(0.0, cper, n)
    rng = _rng(seed, 1)
    perm = rng.permutation(n)
    pool = int(traffic["pool_chunks"])
    return Schedule(period=period, chunk_period=cper,
                    chunk_phase=chunk[perm], close_phase=close[perm],
                    offset=rng.integers(0, pool, n),
                    labs_offset=rng.integers(0, pool, n))


@dataclasses.dataclass
class Pool:
    ecg: np.ndarray      # [pool, leads, chunk samples] float32
    vitals: np.ndarray   # [pool, channels, chunk samples] float32
    labs: np.ndarray     # [pool, labs] float32


def make_pool(traffic: Dict, config: Dict, seed: int) -> Pool:
    rng = _rng(seed, 2)
    n = int(traffic["pool_chunks"])
    cs = float(traffic["chunk_seconds"])
    ke = int(round(config["ecg_hz"] * cs))
    kv = int(round(config["vitals_hz"] * cs))
    return Pool(
        ecg=rng.standard_normal((n, config["ecg_leads"], ke), np.float32),
        vitals=rng.standard_normal((n, config["vitals_channels"], kv),
                                   np.float32),
        labs=rng.standard_normal((n, config["labs"]), np.float32))


@dataclasses.dataclass
class Query:
    qid: int
    bed: int
    due: float          # schedule seconds
    fed: int            # chunks fed to the bed when its window closed
    mark: int           # chunks fed at its previous close
    labs_row: int


class FeedBook:
    """The harness's own record of what it fed: chunks a bed has been
    sent (the prefill counts as ``prefill`` chunks) and every closed
    window, from which the reference rebuilds each window."""

    def __init__(self, schedule: Schedule, pool_rows: int, prefill: int):
        self.s = schedule
        self.rows = pool_rows
        self.fed = np.full(schedule.n_beds, prefill, np.int64)
        self.mark = np.zeros(schedule.n_beds, np.int64)
        self.closes = np.zeros(schedule.n_beds, np.int64)
        self.queries: List[Query] = []

    def rows_of(self, bed: int, lo: int, hi: int) -> np.ndarray:
        return (self.s.offset[bed] + np.arange(lo, hi)) % self.rows

    def chunk(self, bed: int) -> int:
        """The pool row of the bed's next chunk; counts it fed."""
        row = int((self.s.offset[bed] + self.fed[bed]) % self.rows)
        self.fed[bed] += 1
        return row

    def close(self, bed: int, due: float) -> Query:
        q = Query(qid=len(self.queries), bed=bed, due=due,
                  fed=int(self.fed[bed]), mark=int(self.mark[bed]),
                  labs_row=int((self.s.labs_offset[bed] + self.closes[bed])
                               % self.rows))
        self.mark[bed] = self.fed[bed]
        self.closes[bed] += 1
        self.queries.append(q)
        return q


def window(book: FeedBook, pool_mod: np.ndarray, q: Query,
           want: int) -> np.ndarray:
    """A closed window as the aggregator contract defines it: the last
    ``min(samples since the previous close, want)`` samples the bed was
    sent, oldest first, left-filled with zeros to ``want``."""
    k = pool_mod.shape[-1]
    valid = min((q.fed - q.mark) * k, want)
    n_chunks = -(-valid // k)
    rows = book.rows_of(q.bed, q.fed - n_chunks, q.fed)
    x = pool_mod[rows].transpose(1, 0, 2).reshape(pool_mod.shape[1], -1)
    out = np.zeros((pool_mod.shape[1], want), np.float32)
    if valid:
        out[:, want - valid:] = x[:, x.shape[1] - valid:]
    return out


def offline_queries(schedule: Schedule, pool_rows: int, prefill: int,
                    t_lo: float, t_hi: float) -> Tuple[FeedBook, List[Query]]:
    """Walk the schedule without serving anything: the book and the
    queries due in ``[t_lo, t_hi)``, exactly as a run feeds them."""
    book = FeedBook(schedule, pool_rows, prefill)
    for t, kind, b in schedule.events():
        if t >= t_hi:
            break
        if kind == CHUNK:
            book.chunk(b)
        else:
            book.close(b, t)
    return book, [q for q in book.queries if t_lo <= q.due < t_hi]

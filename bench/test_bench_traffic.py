"""The schedule made from a seed: rate, phases, bursts, determinism, and
the windows the reference rebuilds from it."""
import numpy as np

from bench.harness import traffic as tr


def _events(schedule, t_end):
    out = []
    for t, kind, bed in schedule.events():
        if t >= t_end:
            return out
        out.append((t, kind, bed))


def test_same_seed_same_schedule_and_pool(tiny_cell):
    c = tiny_cell
    a = tr.make_schedule(c.traffic, c.config, 2 ** 31 + 5)
    b = tr.make_schedule(c.traffic, c.config, 2 ** 31 + 5)
    assert _events(a, 3.0) == _events(b, 3.0)
    pa, pb = (tr.make_pool(c.traffic, c.config, 2 ** 31 + 5)
              for _ in range(2))
    assert np.array_equal(pa.ecg, pb.ecg) and np.array_equal(pa.labs, pb.labs)
    other = tr.make_pool(c.traffic, c.config, 7)
    assert not np.array_equal(pa.ecg, other.ecg)


def test_every_seed_offers_the_same_arrivals(tiny_cell):
    c = tiny_cell
    a = tr.make_schedule(c.traffic, c.config, 1)
    b = tr.make_schedule(c.traffic, c.config, 99)
    assert not np.array_equal(a.close_phase, b.close_phase)
    assert np.array_equal(np.sort(a.close_phase), np.sort(b.close_phase))
    assert np.array_equal(np.sort(a.chunk_phase), np.sort(b.chunk_phase))


def test_rate_each_bed_closes_once_a_period(tiny_cell):
    c = tiny_cell
    s = tr.make_schedule(c.traffic, c.config, 3)
    period = float(c.config["window_seconds"])
    ev = _events(s, 10 * period)
    closes = [b for _, k, b in ev if k == tr.CLOSE]
    chunks = [b for _, k, b in ev if k == tr.CHUNK]
    assert np.bincount(closes).tolist() == [10] * s.n_beds
    per = period / float(c.traffic["chunk_seconds"])
    assert np.bincount(chunks).tolist() == [round(10 * per)] * s.n_beds
    times = [t for t, _, _ in ev]
    assert times == sorted(times)
    assert all(0 <= p < period for p in s.close_phase)


def test_herd_closes_a_unit_at_one_instant(tiny_herd):
    c = tiny_herd
    c.traffic = dict(c.traffic, beds=14, unit_beds=5)
    s = tr.make_schedule(c.traffic, c.config, 11)
    phases, counts = np.unique(s.close_phase, return_counts=True)
    assert len(phases) == 3 and sorted(counts.tolist()) == [4, 5, 5]
    assert len(np.unique(s.chunk_phase)) == 3
    ev = _events(s, float(c.config["window_seconds"]))
    burst = [t for t, k, _ in ev if k == tr.CLOSE]
    assert len(set(burst)) == 3 and len(burst) == 14


def test_steady_beds_are_desynchronised(tiny_cell):
    c = tiny_cell
    s = tr.make_schedule(c.traffic, c.config, 4)
    assert len(np.unique(s.close_phase)) == s.n_beds


def test_window_is_the_last_chunks_zero_filled(tiny_cell):
    c = tiny_cell
    s = tr.make_schedule(c.traffic, c.config, 5)
    pool = tr.make_pool(c.traffic, c.config, 5)
    book = tr.FeedBook(s, len(pool.ecg), prefill=5)
    for _ in range(3):
        book.chunk(0)
    q = book.close(0, 0.0)                       # 8 chunks, mark 0
    full = np.concatenate(pool.ecg[book.rows_of(0, 0, 8)], axis=-1)
    assert np.array_equal(tr.window(book, pool.ecg, q, 250), full[:, -250:])
    book.chunk(0)
    book.chunk(0)
    q2 = book.close(0, 1.0)                      # 2 chunks since the close
    w = tr.window(book, pool.ecg, q2, 250)
    assert np.all(w[:, :150] == 0)
    assert np.array_equal(w[:, 150:], np.concatenate(
        pool.ecg[book.rows_of(0, 8, 10)], axis=-1))


def test_offline_walk_matches_the_events(tiny_cell):
    c = tiny_cell
    s = tr.make_schedule(c.traffic, c.config, 6)
    book, qs = tr.offline_queries(s, 64, 5, 0.5, 1.5)
    assert len(qs) == s.n_beds
    assert all(0.5 <= q.due < 1.5 for q in qs)
    assert all(q.fed - q.mark == 5 for q in qs if q.mark)

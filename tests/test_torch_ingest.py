"""The port's device-resident ingest against the JAX package's.

Both packages' ``DeviceIngest`` are fed the same chunks; their rings,
``write_idx``, ``total``, ``fed``, ``mark`` and the refs they close must
be BITWISE equal — across ring wraparound, a ``write_idx`` wrap at a
non-pow2 capacity, and ``grow``.  The staleness guards must raise in
both packages.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serving import aggregator as ja
from repro_torch.serving import aggregator as ta
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
WINDOW = 1.0


def _mods(pkg):
    return [pkg.ModalitySpec("ecg", 250.0, 3),
            pkg.ModalitySpec("vitals", 1.0, 7)]


def _pair(n):
    return (ja.DeviceIngest(_mods(ja), n, WINDOW),
            ta.DeviceIngest(_mods(ta), n, WINDOW, device="cpu"))


def _feed(pair, t, patient, modality, samples):
    for di in pair:
        di.ingest(t, patient, modality, samples)


def _assert_same_state(jdi, tdi):
    for name in jdi.states:
        js, ts = jdi.states[name], tdi.states[name]
        assert_bitwise(ts.buf, np.asarray(js.buf), f"{name} ring")
        assert_bitwise(ts.write_idx, np.asarray(js.write_idx), name)
        assert_bitwise(ts.total, np.asarray(js.total), name)
        assert_bitwise(tdi.fed[name], jdi.fed[name], f"{name} fed")
        assert_bitwise(tdi.mark[name], jdi.mark[name], f"{name} mark")
    assert tdi.window_start == jdi.window_start


def _assert_same_ref(jr, tr):
    assert (tr.patient, tr.ends, tr.valid) == (jr.patient, jr.ends,
                                               jr.valid)
    assert tr.extra.keys() == jr.extra.keys()


def _stream(rng, pair, patients, windows, chunk_choices=(50, 64, 100, 37)):
    """Several windows of mixed-size ECG chunks plus 1 Hz vitals;
    returns the refs closed by each package."""
    refs = []
    for w in range(windows):
        for p in patients:
            off = 0
            while off < 250:
                k = min(int(rng.choice(chunk_choices)), 250 - off)
                _feed(pair, w + off / 250.0, p, "ecg",
                      rng.standard_normal((3, k)).astype(np.float32))
                off += k
            _feed(pair, float(w), p, "vitals",
                  rng.standard_normal((7, 1)).astype(np.float32))
            refs.append(tuple(di.close_window(p, w + WINDOW)
                              for di in pair))
    return refs


def test_rings_and_refs_bitwise_across_wraparound():
    rng = np.random.default_rng(0)
    pair = _pair(3)
    refs = _stream(rng, pair, [0, 2], windows=5)      # 1250 > cap 512
    assert pair[1].fed["ecg"][0] == 1250 > pair[1].states["ecg"].buf.shape[-1]
    _assert_same_state(*pair)
    for jr, tr in refs:
        _assert_same_ref(jr, tr)


def test_gather_and_read_window_bitwise_after_wrap():
    rng = np.random.default_rng(1)
    pair = _pair(3)
    refs = _stream(rng, pair, [0, 1, 2], windows=3)
    jdi, tdi = pair
    last = [t for _, t in refs[-3:]]
    for name, L in (("ecg", 250), ("ecg", 100), ("vitals", 1)):
        pts = [r.patient for r in last] + [0]
        ends = [r.ends[name] for r in last] + [0]
        valid = [r.valid[name] for r in last] + [0]
        cap = tdi.states[name].buf.shape[-1]
        want = ja.gather_windows(jdi.states[name].buf,
                                 jnp.asarray(pts, jnp.int32),
                                 jnp.asarray(np.mod(ends, cap), jnp.int32),
                                 jnp.asarray(valid, jnp.int32), L)
        got = ta.gather_windows(tdi.states[name].buf, pts, ends, valid, L)
        assert_bitwise(got, np.asarray(want), f"{name} L={L}")
    for p in range(3):
        assert_bitwise(ta.read_window(tdi.states["ecg"], p, 300),
                       np.asarray(ja.read_window_static(jdi.states["ecg"],
                                                        p, 300)))
        for (jr, tr) in refs[-3:]:
            assert_bitwise(tr.host_window("vitals"),
                           jr.host_window("vitals"))


def test_write_idx_wrap_at_non_pow2_capacity():
    """cap=12 does not divide 2**30: ``write_idx`` must wrap at
    ``ring_wrap(12)``, a multiple of 12, in both packages."""
    cap = 12
    wrap = ta.ring_wrap(cap)
    assert wrap == ja.ring_wrap(cap) and wrap % cap == 0
    js = ja.agg_init(2, 2, cap)
    ts = ta.agg_init(2, 2, cap, device="cpu")
    seed = wrap - 5
    js = js._replace(write_idx=js.write_idx.at[1].set(seed))
    ts.write_idx[1] = seed
    rng = np.random.default_rng(2)
    for k in (3, 4, 7, 12, 1):
        chunk = rng.standard_normal((2, k)).astype(np.float32)
        js = ja.ingest_chunk(js, 1, chunk)
        ts = ta.ingest_chunk(ts, 1, chunk)
        assert_bitwise(ts.buf, np.asarray(js.buf), f"k={k}")
        assert_bitwise(ts.write_idx, np.asarray(js.write_idx), f"k={k}")
        assert_bitwise(ts.total, np.asarray(js.total), f"k={k}")
    assert int(ts.write_idx[1]) < seed                 # it wrapped


def test_grow_keeps_rows_bitwise_and_new_rows_empty():
    rng = np.random.default_rng(3)
    pair = _pair(2)
    _stream(rng, pair, [0, 1], windows=2)
    for di in pair:
        di.grow(5)
        di.grow(3)                                     # no-op when smaller
    _assert_same_state(*pair)
    refs = _stream(rng, pair, [1, 4], windows=2)
    _assert_same_state(*pair)
    for jr, tr in refs:
        _assert_same_ref(jr, tr)
    assert pair[1].states["ecg"].buf.shape[0] == 5


def test_headroom_matches_reference():
    rng = np.random.default_rng(4)
    pair = _pair(2)
    _stream(rng, pair, [0], windows=1)
    _feed(pair, 1.0, 0, "vitals", np.zeros((7, 1), np.float32))
    jdi, tdi = pair
    for p in range(2):
        assert tdi.headroom(p) == jdi.headroom(p)
        assert tdi.headroom_by_modality(p) == jdi.headroom_by_modality(p)


def test_stale_refs_raise_in_both_packages():
    """Feeding past a ref's window overwrites it: ``host_window`` and
    the flush guard refuse it in both packages; the vitals ring overruns
    on its own clock."""
    rng = np.random.default_rng(5)
    pair = _pair(1)
    (jr, tr), = _stream(rng, pair, [0], windows=1)
    for _ in range(2):                                 # 500 more > cap
        _feed(pair, 1.0, 0, "ecg",
              rng.standard_normal((3, 250)).astype(np.float32))
    for r in (jr, tr):
        with pytest.raises(ValueError, match="stale"):
            r.host_window("ecg")
    with pytest.raises(ValueError, match="stale"):
        pair[1].check_fresh("ecg", [tr], 250)
    for _ in range(2):                                 # vitals cap is 2
        _feed(pair, 2.0, 0, "vitals", np.zeros((7, 1), np.float32))
    for r in (jr, tr):
        with pytest.raises(ValueError, match="vitals ring"):
            r.host_window("vitals")


def test_ingest_rejects_oversized_chunk_and_bad_patient():
    ts = ta.agg_init(2, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        ta.ingest_chunk(ts, 0, np.zeros((1, 9), np.float32))
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        ja.ingest_chunk(ja.agg_init(2, 1, 8), 0, np.zeros((1, 9),
                                                          np.float32))
    with pytest.raises(IndexError):
        ta.ingest_chunk(ts, 2, np.zeros((1, 3), np.float32))
    with pytest.raises(IndexError):
        ta.gather_windows(ts.buf, [2], [0], [1], 4)


def test_patient_aggregator_copy_matches_reference():
    rng = np.random.default_rng(6)
    jagg = ja.PatientAggregator(_mods(ja), 1.0)
    tagg = ta.PatientAggregator(_mods(ta), 1.0)
    for j in range(12):
        chunk = rng.standard_normal((3, 25)).astype(np.float32)
        for agg in (jagg, tagg):
            agg.ingest(j * 0.1, "ecg", chunk)
    assert jagg.window_ready(1.1) and tagg.window_ready(1.1)
    jw, tw = jagg.pop_window(1.1), tagg.pop_window(1.1)
    for name in jw:
        assert_bitwise(tw[name], jw[name], name)


def test_ingest_lock_makes_guard_and_gather_atomic():
    """Ingest threads racing a reader: every gather done under the lock
    returns exactly the samples of the window its guard passed (a chunk
    written between the two would tear it)."""
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 8.0, 1)], 1, 1.0,
                         capacity_windows=1.0, device="cpu")   # cap 8
    stop = threading.Event()
    errors = []

    def writer():
        v = 0
        while not stop.is_set():
            di.ingest(0.0, 0, "ecg", np.array([[v, v + 1]], np.float32))
            v += 2

    def reader():
        for _ in range(300):
            with di.lock:
                fed = int(di.fed["ecg"][0])
                win = ta.gather_windows(di.states["ecg"].buf, [0], [fed],
                                        [min(fed, 8)], 8)[0, 0]
            want = np.arange(fed - 8, fed, dtype=np.float32)
            want[want < 0] = 0
            if not np.array_equal(win.numpy(), want):
                errors.append((fed, win.numpy()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=writer)
    thread.start()
    try:
        reader()
    finally:
        stop.set()
        thread.join(timeout=10)
        sys.setswitchinterval(old)
    assert not thread.is_alive()
    assert not errors, errors[:3]

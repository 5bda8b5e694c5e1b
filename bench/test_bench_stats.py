"""Exact percentiles, the device-busy union with overlapping intervals,
the conv counts against a hand count, and the trace's reduction."""
import pytest

from bench.counts.convs import conv_bound_s, conv_counts, flush_conv_bound_s
from bench.counts.peaks import HBM_BYTES_S, TF32_FLOP_S
from bench.harness.stats import flushes_of, gaps, merge, percentile, union_length
from bench.harness.trace import summarize


def test_percentiles_are_exact():
    x = list(range(1, 101))                     # 1..100
    assert percentile(x, 50) == 50.5
    assert percentile(x, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile([5, 1, 3], 50) == 3.0
    with pytest.raises(ValueError):
        percentile([], 50)


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (6, 7), (10, 11)]
    assert merge(iv) == [(0, 3), (5, 7), (10, 11)]
    assert union_length(iv) == 6
    assert gaps(iv, -1, 12) == [(-1, 0), (3, 5), (7, 10), (11, 12)]
    assert gaps(iv, 1, 6.5) == [(3, 5)]


def test_conv_counts_by_hand():
    # one stacked stem conv: M=2 members, B=3 windows, L=10, 1 -> 4
    # channels, K=7, stride 2: L_out 5, pad_total (5-1)*2+7-10 = 5, lo 2;
    # output j reads inputs 2j-2 .. 2j+4 inside [0, 10): taps 5,7,7,6,4
    flops, nbytes = conv_counts(2, 3, 10, 1, 4, 7, 1, 2)
    assert flops == 2 * 2 * 3 * 4 * 1 * (5 + 7 + 7 + 6 + 4)
    assert nbytes == 4 * (2 * 3 * 10 * 1 + 2 * 7 * 1 * 4 + 2 * 4
                          + 2 * 3 * 5 * 4)
    assert conv_bound_s(2, 3, 10, 1, 4, 7, 1, 2) == max(
        nbytes / HBM_BYTES_S, flops / TF32_FLOP_S)
    # a grouped 1x1 conv: every tap inside
    f, _ = conv_counts(1, 1, 8, 16, 16, 1, 4, 1)
    assert f == 2 * 8 * 16 * 4


def test_flush_bound_sums_buckets():
    m = {"width": 8, "blocks": 2, "input_len": 100, "cardinality": 8,
         "kernel_size": 7, "lead": 0}
    one = flush_conv_bound_s([m], 4)
    assert flush_conv_bound_s([m, dict(m, lead=1)], 4) > one
    assert flush_conv_bound_s([m], 8) > one


class _Span:
    def __init__(self, t_flush, batch_n, dispatch_s):
        self.t_flush, self.batch_n, self.dispatch_s = (t_flush, batch_n,
                                                       dispatch_s)


def test_one_span_a_flush():
    sp = [_Span(1.0, 2, 0.1), _Span(1.0, 2, 0.1), _Span(2.0, 1, 0.3)]
    assert len(flushes_of(sp)) == 2


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_ties_kernels_to_their_flush():
    ev = [
        _ev("user_annotation", "bench.ingest", -300, 10, tid=5),
        _ev("cpu_op", "aten::copy_", -150, 20, tid=5),
        _ev("user_annotation", "bench.flush.4", 0, 100, tid=7),
        _ev("cpu_op", "aten::add", 10, 5, tid=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, tid=99, corr=1),
        _ev("cpu_op", "aten::mean", 40, 5, tid=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, tid=99, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 1, tid=99, corr=3),
        _ev("kernel", "conv1d_stripe_tiled_kernel<8>", 20, 10, tid=0, corr=1),
        _ev("kernel", "reduce_kernel", 25, 10, tid=0, corr=2),
        _ev("kernel", "conv1d_stripe_tiled_kernel<8>", 70, 20, tid=0, corr=3),
        _ev("user_annotation", "bench.ingest", 120, 30, tid=5),
        _ev("cpu_op", "aten::index_copy_", 125, 10, tid=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 126, 1, tid=55, corr=4),
        _ev("kernel", "index_copy_kernel", 140, 10, tid=0, corr=4),
        _ev("cpu_op", "aten::empty", 400, 1, tid=5),
    ]
    s = summarize(ev)
    assert s["window_s"] == pytest.approx(701e-6)
    assert s["busy_s"] == pytest.approx(45e-6)   # 20-35, 70-90, 140-150
    assert len(s["flushes"]) == 1
    f = s["flushes"][0]
    assert f["ppad"] == 4 and f["ops"] == 3
    assert f["kernel_s"]["conv1d_stripe_tiled_kernel<8>"] == pytest.approx(
        30e-6)
    idle = dict(s["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(656e-6)
    assert idle["host: aten::copy_"] == pytest.approx(320e-6)   # -300-20
    assert idle["flush: python between ops"] == pytest.approx(35e-6)
    assert idle["no traced host op"] == pytest.approx(301e-6)


def test_a_flush_the_slice_cuts_is_left_out():
    ev = [_ev("user_annotation", "bench.flush.8", 0, 100, tid=7),
          _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, tid=7, corr=1),
          _ev("kernel", "k", 20, 10, tid=0, corr=1),
          _ev("cpu_op", "aten::empty", 500, 1, tid=7)]
    assert summarize(ev)["flushes"] == []


def test_trace_without_device_work_reads_nothing():
    assert summarize([_ev("cpu_op", "aten::add", 0, 5)]) is None

"""The LM decode cell's runner (``bench/harness/zamba2_runner.py``), its
readers, its reference and its control on the CPU, at a tiny cut of the
real configuration and traffic files (its own cut: ``conftest.tiny`` is
the zoo's).  On the CPU the profiler records no device, so the three
``device_trace`` metrics are left out of the traced line there; their
reduction is held on a hand-made chrome trace."""
import math
import time

import numpy as np
import pytest
import torch

from bench.counts import lm as counts
from bench.harness import zamba2_runner
from bench.harness.cells import ROOT, load_cell, load_json, reader
from bench.reference.zamba2 import Zamba2

CELL = "zamba2i-decode-8x3584"
SPEC = load_json(ROOT / "BENCHMARK.json")
NEW = [m["name"] for m in SPEC["per_layer"]
       if m.get("workloads") == [CELL]]
DEVICE = {"shared_block_share", "decode_attention_roofline",
          "flash_attention_roofline"}
CPU = torch.device("cpu")


def lm_tiny(cell):
    """``cell`` cut to seconds of CPU: 9 layers (blocks before 2, 4 and
    7), d 64, 4 heads of 32, 3 sessions of 40 prompt tokens at 20
    steps/s."""
    cell.config = dict(
        cell.config, num_hidden_layers=9, hybrid_layer_ids=[2, 4, 7],
        hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
        attention_head_dim=32, attention_hidden_size=128,
        intermediate_size=128, ffn_hidden_size=128, adapter_rank=8,
        vocab_size=512, mamba_headdim=16, mamba_d_state=16, chunk_size=16,
        max_position_embeddings=96)
    cell.traffic = dict(cell.traffic, sessions=3, prompt_tokens=40,
                        prefill_group=2, step_rate=20.0, pre_seconds=0.3,
                        drain_seconds=5.0, trace_seconds=0.3)
    return cell


@pytest.fixture
def cell():
    return lm_tiny(load_cell(CELL))


def test_the_cell_has_its_seven_metrics():
    """The token latency end to end (the zoo's ``score_p50_ms`` reader
    over the runner's ``latency_s``), and six per-layer metrics that
    move it."""
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert CELL in e2e["score_p50_ms"]["workloads"]
    assert sorted(NEW) == sorted([
        "decode_step_ms", "shared_block_share",
        "decode_attention_roofline", "flash_attention_roofline",
        "decode_hbm_share", "decode_mfu"])
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["moves"] == "score_p50_ms" and "." not in m["name"]


@pytest.mark.parametrize("trace", [False, True])
def test_runner_runs_a_tiny_cut_correct(cell, trace):
    out = zamba2_runner.run(cell, 2 ** 31 + 41, 1.0, trace, CPU,
                        time.monotonic())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 3 * 20
    assert set(out["checks"]) == {"logit_err", "unanswered", "nan_logits"}
    assert out["checks"]["logit_err"]["value"] < 1e-4
    m = out["metrics"]
    if not trace:
        assert set(m) == {"score_p50_ms", "scores_per_s", "setup_s"}
        assert m["scores_per_s"][0] == 60.0
        assert 0 < m["score_p50_ms"][0] < 1e3 * 5.0    # the drain limit
        return
    assert set(m) == set(NEW) - DEVICE
    for name, (v, _) in m.items():
        assert math.isfinite(v) and v > 0, name
    assert out["load"]["positions_end"] == 40 + out["load"]["steps_run"]


def test_runner_refuses_a_census(cell):
    with pytest.raises(ValueError, match="census"):
        zamba2_runner.run(cell, 1, 1.0, False, CPU, time.monotonic(), beds=8)


def test_the_positions_must_fit_the_cache(cell):
    cell.traffic = dict(cell.traffic, step_rate=60.0)
    with pytest.raises(ValueError, match="positions"):
        zamba2_runner.run(cell, 1, 1.0, False, CPU, time.monotonic())


def test_the_tf32_control_fails_the_check(cell):
    r = zamba2_runner.control_reading(cell, 2 ** 33 + 5, 1.0, CPU)
    assert not r["correct"]
    err = r["checks"]["logit_err"]
    assert err["value"] > 10 * err["limit"]


def test_reference_tf32_moves_the_logits(cell):
    pcfg = zamba2_runner.program_config(cell.config)
    params = zamba2_runner.make_params(pcfg, 5, CPU)
    toks = torch.arange(30) % 500
    a = Zamba2(cell.config, params).logits(toks, [29])
    b = Zamba2(cell.config, params, tf32=True).logits(toks, [29])
    assert 1e-4 < float((a - b).abs().max() / a.square().mean().sqrt())


def test_weights_draw_every_constant(cell):
    """Norm scales, conv biases, A_log, D and dt_bias are drawn (no leaf
    is constant), from the seed alone."""
    pcfg = zamba2_runner.program_config(cell.config)
    a = zamba2_runner.make_params(pcfg, 2 ** 40 + 3, CPU)
    b = zamba2_runner.make_params(pcfg, 2 ** 40 + 3, CPU)
    mx = a["mamba"]["mixer"]
    for t in (mx["conv_bx"], mx["A_log"], mx["D"], mx["dt_bias"],
              mx["norm"]["scale"], a["shared"]["ln1"]["scale"],
              a["final_norm"]["scale"]):
        assert float(t.std()) > 0.01
    assert torch.equal(mx["z_proj"], b["mamba"]["mixer"]["z_proj"])
    assert float(mx["A_log"].min()) >= 0 and float(mx["A_log"].max()) <= \
        math.log(16) + 1e-6
    dt = torch.nn.functional.softplus(mx["dt_bias"])
    assert 1e-4 - 1e-7 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6


class _Tree:
    def __init__(self, wall, kv):
        self.root = type("S", (), {"wall_s": wall})()
        self.counts = {"kv_positions": kv}


def _obs(config):
    return {"config": config, "sessions": 8, "peak_flop_s": 495e12,
            "hbm_bytes_s": 3.35e12, "latency_s": [0.1, 0.3, 0.2],
            "steps": [_Tree(0.1, 8 * 13 * 3700), _Tree(0.3, 8 * 13 * 3701)],
            "traced_steps": [_Tree(0.2, 8 * 13 * 3700)]}


def test_readers_on_hand_made_observations():
    conf = load_cell(CELL).config
    obs = _obs(conf)
    obs["step_trace"] = {"steps": 2, "step_device_s": 0.04,
                         "shared_device_s": 0.01, "decode_calls": 26,
                         "decode_s": 0.026}
    obs["prefill_trace"] = {"calls": 13, "device_s": 0.13, "batch": 4,
                            "S": 3584}
    assert reader("score_p50_ms")(obs) == pytest.approx(200.0)
    assert reader("decode_step_ms")(obs) == pytest.approx(200.0)
    assert reader("shared_block_share")(obs) == pytest.approx(25.0)
    bound = counts.decode_attention_bound_s(8, 32, 32, 224, 224, 3700)
    assert reader("decode_attention_roofline")(obs) == pytest.approx(
        100 * bound * 26 / 0.026)
    fb = counts.flash_attention_bound_s(4, 3584, 32, 32, 224, 224)
    assert reader("flash_attention_roofline")(obs) == pytest.approx(
        100 * fb * 13 / 0.13)
    moved = counts.step_bytes(conf, 8, 8 * 13 * 3700) + counts.step_bytes(
        conf, 8, 8 * 13 * 3701)
    assert reader("decode_hbm_share")(obs) == pytest.approx(
        100 * moved / 0.4 / 3.35e12)
    # a step of ~68.6 GB: the issue's figure, weights, K/V and states
    one = counts.step_bytes(conf, 8, 8 * 13 * 3700)
    assert 66e9 < one < 70e9
    flops = counts.step_flops(conf, 8, 8 * 13 * 3700) + counts.step_flops(
        conf, 8, 8 * 13 * 3701)
    assert reader("decode_mfu")(obs) == pytest.approx(
        100 * flops / 0.4 / 495e12)
    for name in NEW:                  # no trace, no steps: nothing
        assert reader(name)({"config": conf, "latency_s": [1.0]}) is None


def test_step_trace_reduces_a_chrome_trace():
    """Two whole steps and one cut by the slice's end; device operations
    tied to their launch by correlation id; the shared block's share and
    the decode kernels (combines not counted as calls)."""
    ev = []

    def ann(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": dur})

    def op(name, launch_ts, corr, ts, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": launch_ts, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})

    ann("holmes.lm.step", 1000, 1000)
    ann("holmes.lm.shared", 1200, 200)
    op("gemm", 1100, 1, 1150, 100)
    op("void decode_split_kernel<256>(Params)", 1300, 2, 1350, 50)
    op("decode_combine_kernel", 1310, 3, 1400, 10)
    ann("holmes.lm.step", 3000, 1000)
    op("gemm", 3100, 4, 3150, 300)
    ann("holmes.lm.step", 5000, 2000)             # cut by the slice's end
    op("gemm", 5100, 5, 5150, 300)
    ev.append({"ph": "X", "cat": "kernel", "name": "tail", "ts": 500,
               "dur": 6560})
    t = zamba2_runner.step_trace(ev)
    assert (t["steps"], t["ops"]) == (2, 4)
    assert t["step_device_s"] == pytest.approx(460e-6)
    assert t["shared_device_s"] == pytest.approx(60e-6)
    assert (t["decode_calls"], t["decode_s"]) == (1, pytest.approx(60e-6))
    pre = zamba2_runner.prefill_trace(
        [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 30,
          "name": "void (anonymous namespace)::flash_prefill_kernel<224, "
                  "224>(Params)"},
         {"ph": "X", "cat": "kernel", "ts": 0, "dur": 30,
          "name": "flash_prefill_kernel<112, 112>"}], 224, 224)
    assert pre == {"calls": 1, "device_s": pytest.approx(30e-6)}


def test_the_reference_scan_is_a_blocking(cell):
    """The reference's chunk only blocks the recurrence: 8 and 16 give
    the same logits within the repo's tolerance."""
    pcfg = zamba2_runner.program_config(cell.config)
    params = zamba2_runner.make_params(pcfg, 9, CPU)
    toks = torch.arange(40) % 500
    a = Zamba2(dict(cell.config, chunk_size=8), params).logits(toks, [39])
    b = Zamba2(dict(cell.config, chunk_size=16), params).logits(toks, [39])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

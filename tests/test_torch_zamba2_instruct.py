"""The published Zamba2 (``Zamba2Config``, ``models/zamba2.py``) against
the benchmark's plain reference (``bench/reference/zamba2.py``) on the
CPU, at a tiny configuration of the same shape: 9 layers with the shared
blocks invoked before layers 2, 4 and 7 (both blocks used, block 0
twice), d 64, 4 heads of 32 over the 128-wide concatenated input, 2
groups of state, adapter rank 8.  The program scans in chunks of 16, the
reference in chunks of 32: the chunk only blocks the recurrence.

* the forward's logits within the repo's tolerance (1e-4);
* prefill, then 3 decode steps, against the full forward within 2e-3,
  the tolerance ``tests/test_torch_hybrid.py`` holds cached decode to
  (the reference's own invariant, ``tests/test_arch_smoke.py``: a step
  sums in another order than the teacher-forced pass);
* each mechanism: the reference with the mechanism taken out lies far
  outside that tolerance from the program, so a program without it
  fails the comparison;
* the published configuration: 7.35 B parameters counted from the
  program's own shapes, and the registry's ten JAX-parity ids as they
  were.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.counts import lm as counts  # noqa: E402
from bench.reference.zamba2 import Zamba2  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.runtime import RuntimeOptions  # noqa: E402
from repro_torch.obs.spans import collect  # noqa: E402
from repro_torch.testing import assert_close  # noqa: E402

torch.set_num_threads(1)
B, S = 2, 24
CACHED_TOL = 2e-3
IDS = (2, 4, 7)
CFG = dataclasses.replace(
    get_config("zamba2-7b-instruct"), num_layers=9, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=96, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  n_groups=2, chunk=16),
    hybrid_layer_ids=IDS, num_mem_blocks=2, adapter_rank=8)
# the same model in the configuration file's keys, as the reference reads
REF_CONFIG = {
    "hidden_size": 64, "num_hidden_layers": 9, "hybrid_layer_ids": list(IDS),
    "num_mem_blocks": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
    "attention_head_dim": 32, "attention_hidden_size": 128,
    "intermediate_size": 96, "adapter_rank": 8, "vocab_size": 256,
    "mamba_d_state": 16, "mamba_headdim": 16, "mamba_expand": 2,
    "mamba_d_conv": 4, "mamba_ngroups": 2, "chunk_size": 32,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0}
RT = RuntimeOptions()


@pytest.fixture(scope="module")
def model():
    params = zamba2.init(torch.Generator().manual_seed(3), CFG, RT,
                                "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (B, S)))
    full, _ = zamba2.forward(params, toks, CFG, RT)
    return params, toks, full


def _ref(params, toks, ref_cls=Zamba2):
    r = ref_cls(REF_CONFIG, params)
    return torch.stack([r.logits(toks[b], range(S)) for b in range(B)])


def _err(a, b) -> float:
    return float((a - b).abs().max())


def test_forward_matches_the_reference(model):
    params, toks, full = model
    assert_close(full, _ref(params, toks))


def test_prefill_then_decode_matches_the_forward(model):
    """Prefill of 21 positions, 3 cached steps; and the same into two
    batch rows of a preallocated cache, one session at a time."""
    params, toks, full = model
    n = S - 3
    lg, cache = zamba2.prefill(params, toks[:, :n], CFG, RT, max_len=S)
    pre = zamba2.init_cache(CFG, RT, B, S, "cpu")
    for b in range(B):
        lgb, pre = zamba2.prefill(params, toks[b:b + 1, :n], CFG, RT,
                                  cache=pre, rows=slice(b, b + 1))
        np.testing.assert_allclose(lgb[0], full[b, n - 1], rtol=CACHED_TOL,
                                   atol=CACHED_TOL)
    np.testing.assert_allclose(lg, full[:, n - 1], rtol=CACHED_TOL,
                               atol=CACHED_TOL)
    for t in range(n, S):
        lg, cache = zamba2.decode_step(params, cache, toks[:, t], CFG, RT)
        lg2, pre = zamba2.decode_step(params, pre, toks[:, t], CFG, RT)
        for got in (lg, lg2):
            np.testing.assert_allclose(got, full[:, t], rtol=CACHED_TOL,
                                       atol=CACHED_TOL)
    assert cache["idx"] == pre["idx"] == S
    assert torch.equal(pre["pos"], torch.arange(S, dtype=torch.int32))


class _NoConcat(Zamba2):
    def shared(self, j, x, x0):
        return super().shared(j, x, torch.zeros_like(x0))


class _InnerResidual(Zamba2):
    """The simplified block's residuals: ``x + a`` into the MLP's norm,
    and the MLP's input added to its output."""

    def shared(self, j, x, x0):
        saved = self.mm
        calls = []

        def mm(a, b):
            y = saved(a, b)
            calls.append(y)
            if len(calls) == 4:                  # the output projection
                y = y + x
            return y
        self.mm = mm
        try:
            t = super().shared(j, x, x0)
        finally:
            self.mm = saved
        return t + calls[3]


class _ToResidual(Zamba2):
    def layer(self, l, x, x0, j):
        y = super().layer(l, x, x0, j)
        return y if j is None else y + self.shared(j, x, x0)


class _UngroupedNorm(Zamba2):
    def norm(self, x, scale, groups=1):
        return super().norm(x, scale, 1)


class _NoConvBias(Zamba2):
    def conv(self, x, w, b):
        return super().conv(x, w, torch.zeros_like(b))


def _one_adapter_a_block(params):
    """Each invocation given its block's first invocation's adapter."""
    inv = dict(params["invocations"])
    nb = CFG.num_mem_blocks
    for name in ("adapter_a", "adapter_b"):
        inv[name] = torch.stack([inv[name][j % nb]
                                 for j in range(len(IDS))])
    return dict(params, invocations=inv)


@pytest.mark.parametrize("mechanism", ["concat input", "no inner residual",
                                       "adapter per invocation",
                                       "output to the Mamba input only",
                                       "grouped norm", "conv bias"])
def test_each_mechanism_is_held(model, mechanism):
    params, toks, full = model
    if mechanism == "adapter per invocation":
        want = _ref(_one_adapter_a_block(params), toks)
    else:
        cls = {"concat input": _NoConcat,
               "no inner residual": _InnerResidual,
               "output to the Mamba input only": _ToResidual,
               "grouped norm": _UngroupedNorm,
               "conv bias": _NoConvBias}[mechanism]
        want = _ref(params, toks, cls)
    assert _err(full, _ref(params, toks)) < 1e-4
    assert _err(full, want) > 10 * CACHED_TOL, mechanism


def test_the_published_configuration():
    """7.35 B parameters from the program's own leaf shapes, as the
    configuration's analytic count and the benchmark's count from the
    configuration file have it; the registry's ids stay the JAX
    package's ten, and the simplified zamba2-7b is not this model."""
    cfg = get_config("zamba2-7b-instruct")
    n = sum(math.prod(shape) for _, shape, _ in zamba2.layout(cfg))
    assert 7.35e9 < n < 7.36e9
    assert n == cfg.param_count()
    conf = json.loads((ROOT / "bench" / "configs" /
                       "zamba2-7b-instruct.json").read_text())
    assert n == counts.param_count(conf)
    assert cfg.flops_per_token(4096) == 2 * counts.weights_read(conf) \
        + 4 * 13 * 7168 * 4096
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.attn_width,
            cfg.adapter_rank, cfg.ssm.n_groups, cfg.hybrid_layer_ids) == (
        conf["num_hidden_layers"], conf["hidden_size"],
        conf["attention_head_dim"], conf["attention_hidden_size"],
        conf["adapter_rank"], conf["mamba_ngroups"],
        tuple(conf["hybrid_layer_ids"]))
    assert cfg.attn_scale == (224 / 2) ** -0.5
    assert "zamba2-7b-instruct" not in ARCH_IDS and len(ARCH_IDS) == 10
    assert type(get_config("zamba2-7b")).__name__ == "ArchConfig"
    r = get_config("zamba2-7b-instruct-reduced")
    assert r.hybrid_layer_ids == (1, 2) and r.num_layers == 3


def test_decode_step_spans_and_counters(model):
    """A traced step: ``lm.step`` over one ``lm.mamba`` run a stretch of
    consecutive Mamba layers, one ``lm.shared`` (``.attn``, ``.mlp``) an
    invocation, ``lm.head``; ``kv_positions`` counts every session's
    attended positions in every invocation; with no sink, nothing."""
    params, toks, _ = model
    _, cache = zamba2.prefill(params, toks[:, :10], CFG, RT, max_len=S)
    with collect("lm.step", cache["idx"]) as tree:
        zamba2.decode_step(params, cache, toks[:, 10], CFG, RT)
    names = [s.name for s in tree.spans]
    assert names.count("lm.mamba") == len(IDS) + 1
    assert names.count("lm.shared") == names.count("lm.shared.attn") \
        == names.count("lm.shared.mlp") == len(IDS)
    assert names[0] == "lm.step" and names[-1] == "lm.head"
    assert tree.ident == 10
    assert tree.counts == {"kv_positions": B * len(IDS) * 11}


def test_greedy_step_records_its_tree(model):
    params, toks, _ = model
    m = get_model(CFG)
    _, cache = m.prefill(params, toks[:, :10], CFG, RT, max_len=S)
    trees = []
    lg, nxt, cache = serve.greedy_step(m, params, cache, toks[:, 10], CFG,
                                       RT, trees=trees)
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    assert len(trees) == 1 and trees[0].kind == "lm.step"
    assert trees[0].counts["launches"] == 0          # the plain versions
    lg2, nxt2, _ = serve.greedy_step(m, params, cache, nxt, CFG, RT)
    assert cache["idx"] == 12 and lg2.shape == lg.shape


@pytest.mark.parametrize("arch", ["zamba2-7b-instruct-reduced"])
def test_serve_runs_the_published_zamba2_on_the_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--new-tokens", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["arch"] == arch and rec["device"] == "cpu"
    assert rec["decode_ms_per_token"] > 0

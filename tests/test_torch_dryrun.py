"""The port's production-mesh dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``, ``launch/ensemble_parallel.py``).

* Accounting, exact: on the fake 16x16 mesh a ``[1024, 512] @ [512,
  2048]`` product, batch over "data" and columns over "model", counts
  flops / 256 on rank 0 (the reference's calibration,
  ``repro/launch/roofline.py:17-19``); a collective counts its result
  bytes under its kind.
* ``probe_pair``, ``_extrapolate`` and ``model_flops`` identical to the
  reference's; the roofline's extrapolated flops equal a direct count of
  the full layer stack (the port runs every layer).
* Dry runs of reduced archs on both production meshes: qwen3-4b at
  train_4k and decode_32k, zamba2-7b at decode_32k (the MoE dry runs
  are in ``test_torch_moe_sharded.py``, the counts held against the
  reference's in ``test_torch_dryrun_reference.py``);
  ``dryrun_ensemble``; ``main``'s exit code.  Reshard rules on real
  values: the depthwise conv, the per-sequence scatter and take; the
  gradient layout of ``_local``.
* ``ensemble_serve`` over a one-rank gloo mesh: bitwise the lane form.

Every test that makes a process group tears it down, also when it fails.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

import jax

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.configs import shapes as jshapes
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.device import lanes
from repro_torch.launch import dryrun, ensemble_parallel, mesh, roofline
from repro_torch.launch import sharding
from repro_torch.models import layers

# the reference dry run's record keys (``repro/launch/dryrun.py:145-163``)
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "flops",
               "bytes_accessed", "collective_bytes", "collective_total",
               "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "lower_s", "compile_s", "params", "active_params", "kv_mult",
               "window"}
torch.set_num_threads(1)


@pytest.fixture
def group():
    """Tears down whatever process group the test made."""
    mesh.teardown()
    yield
    mesh.teardown()


@pytest.fixture(scope="module")
def jroofline():
    """The reference's roofline module.  Importing it sets XLA_FLAGS
    (512 host devices) when unset: JAX is initialised first, so this
    process keeps its devices, and the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import roofline as jr
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jr


# ------------------------------------------------------------- accounting
def test_sharded_product_counts_flops_per_device(group):
    m = mesh.make_production_mesh()
    with FakeTensorMode():
        x = sharding.shard(torch.empty(1024, 512), (Shard(0), Replicate()),
                           m)
        w = sharding.shard(torch.empty(512, 2048), (Replicate(), Shard(1)),
                           m)
        counter = dryrun.StepCounter()
        with counter:
            y = x @ w
    assert counter.flops == 2 * 1024 * 512 * 2048 / 256
    assert y.placements == (Shard(0), Shard(1))
    assert counter.collective_bytes == {k: 0 for k in dryrun._COLLECTIVES}
    # the operands and the result, each once, on rank 0's shards
    assert counter.bytes_accessed == 4 * (64 * 512 + 512 * 128 + 64 * 128)


def test_collectives_counted_by_kind(group):
    m = mesh.make_production_mesh()
    with FakeTensorMode():
        t = torch.empty(8, 16)
        d = sharding.shard(torch.empty(32, 4), (Replicate(), Shard(0)), m)
        part = DTensor.from_local(torch.empty(32, 4), m,
                                  (Replicate(), Partial()), run_check=False)
        counter = dryrun.StepCounter()
        with counter:
            dist.all_reduce(t, group=m.get_group("model"))
            whole = d.redistribute(placements=(Replicate(), Replicate()))
            part.redistribute(placements=(Replicate(), Replicate()))
    assert tuple(whole.to_local().shape) == (32, 4)
    got = counter.collective_bytes
    assert got["all-gather"] == 32 * 4 * 4
    assert got["all-reduce"] == 8 * 16 * 4 + 32 * 4 * 4
    assert got["reduce-scatter"] == got["all-to-all"] == 0


# ------------------------------------------------------------- roofline
def test_roofline_helpers_match_reference(jroofline):
    rng = np.random.default_rng(0)
    for arch in ARCH_IDS:
        j = jroofline.probe_pair(j_get_config(arch))
        t = roofline.probe_pair(get_config(arch))
        for a, b in zip(j, t):
            if isinstance(a, float):
                assert a == b, arch
            else:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        for name in jshapes.SHAPES:
            assert roofline.model_flops(get_config(arch), get_shape(name)) \
                == jroofline.model_flops(j_get_config(arch),
                                         jshapes.get_shape(name))
    kinds = dryrun._COLLECTIVES

    def metrics():
        out = {k: float(rng.integers(1, 10 ** 9)) for k in roofline._METRICS}
        out["collective_bytes"] = {k: float(rng.integers(0, 10 ** 9))
                                   for k in kinds}
        return out
    mA, mB = metrics(), metrics()
    assert roofline._extrapolate(mA, 2.0, mB, 4.0, 27.0) \
        == jroofline._extrapolate(mA, 2.0, mB, 4.0, 27.0)


def test_roofline_extrapolation_equals_direct_count():
    cfg = dataclasses.replace(get_config("qwen3-4b-reduced"),
                              name="qwen3-4b-6l", num_layers=6)
    registry._ARCHS[cfg.name] = cfg
    try:
        rec = roofline.roofline_one(cfg.name, "prefill_32k", verbose=False)
        direct = dryrun.dryrun_one(cfg.name, "prefill_32k", verbose=False)
    finally:
        registry._ARCHS.pop(cfg.name)
    assert rec["hlo_flops_per_dev"] == direct["flops"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["memory_s_upper_bound"] is True
    assert rec["compute_s"] == direct["flops"] / 989.4e12
    assert not dist.is_initialized()


# ------------------------------------------------------------- dry runs
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b-reduced", "train_4k"), ("qwen3-4b-reduced", "decode_32k"),
    ("zamba2-7b-reduced", "decode_32k")])
def test_dryrun_record(arch, shape, multi_pod, group):
    rec = dryrun.dryrun_one(arch, shape, multi_pod, verbose=False)
    assert not dist.is_initialized()
    assert RECORD_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_devices"]) == (
        ("2x16x16", 512) if multi_pod else ("16x16", 256))
    assert rec["kind"] == get_shape(shape).kind
    assert rec["flops"] > 0 and rec["bytes_accessed"] > rec["flops"] / 1e3
    assert rec["collective_total"] == sum(rec["collective_bytes"].values())
    assert rec["peak_bytes"] >= rec["argument_bytes"] > 0
    assert rec["temp_bytes"] == rec["peak_bytes"] - rec["argument_bytes"]
    assert rec["params"] == get_config(arch).param_count()
    # 4 query heads over a model axis of 16: the head split is resharded
    assert any(k.startswith("uneven head split")
               for k in rec["reshards"]), rec["reshards"]
    # no fake tensor is left in the cache the served paths read
    assert layers._rope_freqs.cache_info().currsize == 0


def test_reshard_depthwise_conv_runs_on_local_channels(group):
    """mamba's causal short conv (``groups`` = channels) with its
    channels sharded over "model": each rank convolves its own."""
    m = mesh.make_production_mesh()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 64, 12)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 1, 4)).astype(np.float32))
    want = torch.conv1d(x, w, groups=64)
    xd = sharding.shard(x, (Shard(0), Shard(1)), m)
    wd = sharding.shard(w, (Replicate(), Shard(0)), m)
    reshard = dryrun.Reshard()
    with implicit_replication(), reshard:
        got = torch.conv1d(xd, wd, groups=64)
    assert got.placements == (Shard(0), Shard(1))
    # rank 0 holds sequence 0 and channels 0-3
    assert torch.equal(got.to_local(), want[:1, :4])
    assert list(reshard.sites) == [
        "depthwise conv over sharded channels at ?"]


def test_reshard_per_sequence_scatter_and_take_stay_on_local_rows(group):
    """The MoE dispatch under gspmd: a scatter of batch-sharded values
    into a per-sequence buffer made in the model, and the take back,
    run on each rank's own sequences; rank 0 holds sequences 0-1 of 32
    and their rows of the buffer, equal to the whole scatter's."""
    m = mesh.make_production_mesh()
    rng = np.random.default_rng(0)
    B, n, E, C, d = 32, 6, 3, 4, 5
    vals = torch.from_numpy(rng.standard_normal((B, n, d)).astype(
        np.float32))
    bidx = torch.arange(B)[:, None].expand(B, n)
    e = torch.from_numpy(rng.integers(0, E, (B, n)))
    slot = torch.from_numpy(rng.integers(0, C, (B, n)))
    want = torch.zeros(B, E, C, d).index_put_((bidx, e, slot), vals,
                                              accumulate=True)
    on_batch = (Shard(0), Replicate())
    vd, ed, sd = (sharding.shard(t, on_batch, m) for t in (vals, e, slot))
    reshard = dryrun.Reshard()
    with implicit_replication(), reshard:
        got = torch.zeros(B, E, C, d).index_put_((bidx, ed, sd), vd,
                                                 accumulate=True)
        back = got[bidx, ed, sd]
    assert got.placements == back.placements == on_batch
    assert torch.equal(got.to_local(), want[:2])
    assert torch.equal(back.to_local(), want[bidx, e, slot][:2])
    assert sorted(k.split(" at ")[0] for k in reshard.sites) == [
        "scatter into a per-sequence buffer",
        "take from a per-sequence buffer"]


def test_local_map_gradients_keep_partial_sums(group):
    """``_local``: an input replicated over a mesh dim that the compute
    splits gets its gradient as a partial sum there (``local_map`` alone
    would call it replicated and drop the reduction)."""
    m = mesh.make_production_mesh()
    with FakeTensorMode():
        x = sharding.shard(torch.empty(8, 16), (Replicate(), Replicate()),
                           m).requires_grad_()
        w = sharding.shard(torch.empty(16, 32), (Replicate(), Shard(1)),
                           m).requires_grad_()
        y = dryrun._local(lambda a, b: a @ b, m,
                          ((Replicate(), Replicate()), (Replicate(),
                                                        Shard(1))),
                          [Replicate(), Shard(1)], x, w)
        y.sum().backward()
    assert x.grad.placements == (Replicate(), Partial())
    assert w.grad.placements == (Replicate(), Shard(1))


def test_dryrun_main_reports_and_exits_nonzero_on_a_failure(
        monkeypatch, capsys, tmp_path):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "qwen3-4b-reduced", "--shape",
                        "decode_32k", "--out", str(out)]) == 0
    assert "1 OK, 0 failed" in capsys.readouterr().out
    real = dryrun.dryrun_one

    def flaky(arch, shape, multi_pod, **kw):
        if multi_pod:
            raise RuntimeError("refused")
        return real(arch, shape, multi_pod, **kw)
    monkeypatch.setattr(dryrun, "dryrun_one", flaky)
    assert dryrun.main(["--arch", "qwen3-4b-reduced", "--shape",
                        "decode_32k", "--both-meshes"]) == 1
    captured = capsys.readouterr()
    assert "1 OK, 1 failed" in captured.out and "FAIL" in captured.err


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_dryrun_ensemble(multi_pod, group):
    rec = ensemble_parallel.dryrun_ensemble(multi_pod=multi_pod,
                                            verbose=False)
    assert set(rec) == {"mesh", "n_members", "collective_bytes", "flops"}
    per_member = 2 * 64 * 512 * 512 + 2 * 64 * 512 * 2
    assert rec["flops"] == per_member * (2 if multi_pod else 4)
    # one all-reduce of the [64, 2] bf16 scores over "pod"
    assert rec["collective_bytes"]["all-reduce"] == (
        64 * 2 * 2 if multi_pod else 0)
    assert not dist.is_initialized()


def test_ensemble_serve_on_a_mesh_is_the_lane_form(group):
    rng = np.random.default_rng(0)
    stacked = {"w1": torch.from_numpy(
        rng.standard_normal((4, 16, 16)).astype(np.float32)),
        "w2": torch.from_numpy(
            rng.standard_normal((4, 16, 2)).astype(np.float32))}
    batch = {"x": torch.from_numpy(
        rng.standard_normal((8, 16)).astype(np.float32))}

    def member_apply(p, b):
        return torch.softmax(torch.tanh(b["x"] @ p["w1"]) @ p["w2"], dim=-1)
    want = ensemble_parallel.ensemble_serve(
        member_apply, lanes(1, "cpu"), 4)(stacked, batch)
    got = ensemble_parallel.ensemble_serve(
        member_apply, mesh.make_host_mesh("cpu"), 4)(stacked, batch)
    assert type(got) is torch.Tensor and torch.equal(got, want)

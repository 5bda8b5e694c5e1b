"""The port's sharded MoE (``models/moe.py::moe_apply_sharded``) against
``moe_apply`` and the JAX package's shard_map variant.

* On a one-rank gloo mesh (``make_host_mesh("cpu")``), for each MoE
  arch reduced: output, aux and every grad BITWISE equal to the port's
  ``moe_apply`` (a one-rank all-reduce is a copy), and within the one
  tolerance of the JAX package's ``moe_apply_sharded`` on its host mesh
  (the counterpart of ``tests/test_perf_levers.py:41-68``);
* through the model: ``RuntimeOptions(moe_impl="shard_map", mesh=...)``
  routes every MoE layer there, logits bitwise the gspmd path's;
* on two gloo ranks (spawned, a ``FileStore``) over a ``(1, 2)`` mesh,
  expert f split between them, and over a ``(2, 1)`` mesh, the batch
  split between them: output, aux and every grad, whole on each rank,
  within 1e-4 of the unsharded ones;
* DTensor inputs on the 16x16 fake mesh: each param's gradient a
  partial sum over "data";
* the production-mesh dry run of deepseek-v2-lite-16b reduced with both
  ``moe_impl``s (train_4k on 16x16, decode_32k on 2x16x16): the
  shard_map schedule moves fewer collective bytes, and only the gspmd
  path needs the dispatch resharded.

Every test that makes a process group tears it down, also when it fails.
"""
import multiprocessing as mp

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, mesh
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ecg_resnext import leaves, map_params
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_close
from repro_torch.training.train_loop import value_and_grad

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b-reduced", "deepseek-v2-lite-16b-reduced"]
KEY = jax.random.PRNGKey(0)
torch.set_num_threads(1)


@pytest.fixture
def group():
    """Tears down whatever process group the test made."""
    mesh.teardown()
    yield
    mesh.teardown()


def _inputs(arch, B=2, S=16, seed=0):
    """The JAX package's init, carried across, and a seeded input."""
    jp = jmoe.init_moe(KEY, j_get_config(arch))
    x = (np.random.default_rng(seed).standard_normal(
        (B, S, get_config(arch).d_model)) * 0.1).astype(np.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp)), x


def _loss(fn):
    def loss(p, x):
        y, aux = fn(p, x)
        return (y ** 2).sum() + aux
    return loss


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_on_one_rank_is_moe_apply_bitwise(arch, group):
    cfg = get_config(arch)
    jp, p, x_np = _inputs(arch)
    x = torch.from_numpy(x_np)
    m = mesh.make_host_mesh("cpu")
    y1, a1 = moe.moe_apply(p, x, cfg)
    y2, a2 = moe.moe_apply_sharded(p, x, cfg, m)
    assert type(y2) is torch.Tensor
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    jy, ja = jax.jit(lambda q, x_: jmoe.moe_apply_sharded(
        q, x_, j_get_config(arch), j_host_mesh()))(jp, jnp.asarray(x_np))
    assert_close(y2, np.asarray(jy), f"{arch} y vs JAX")
    assert_close(a2, np.asarray(ja), f"{arch} aux vs JAX")

    l1, g1 = value_and_grad(lambda q: _loss(lambda q_, x_: moe.moe_apply(
        q_, x_, cfg))(q, x), p)
    l2, g2 = value_and_grad(lambda q: _loss(
        lambda q_, x_: moe.moe_apply_sharded(q_, x_, cfg, m))(q, x), p)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    jcfg, xj, jm = j_get_config(arch), jnp.asarray(x_np), j_host_mesh()

    def j_loss(q):
        y, aux = jmoe.moe_apply_sharded(q, xj, jcfg, jm)
        return jnp.sum(y ** 2) + aux
    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jp)
    assert_close(l2, np.asarray(jl), f"{arch} loss vs JAX")
    for got, want in zip(leaves(g2), leaves(params_from_numpy(
            jax.tree.map(np.asarray, jg)))):
        assert_close(got, want, f"{arch} grad vs JAX")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_routes_moe_layers_to_the_sharded_path(arch, group,
                                                    monkeypatch):
    cfg = get_config(arch)
    rt = RuntimeOptions(impl="torch")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    calls = []
    real = moe.moe_apply_sharded

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    want = model.forward(params, toks, cfg, rt)
    monkeypatch.setattr(moe, "moe_apply_sharded", counted)
    got = model.forward(params, toks, cfg, RuntimeOptions(
        impl="torch", moe_impl="shard_map", mesh=mesh.make_host_mesh("cpu")))
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    assert len(calls) == n_moe
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _two_rank_worker(rank, path, arch, shape, p, x, out):
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2)
    try:
        m = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cfg = get_config(arch)
        y, aux = moe.moe_apply_sharded(p, x, cfg, m)
        _, g = value_and_grad(lambda q: _loss(
            lambda q_, x_: moe.moe_apply_sharded(q_, x_, cfg, m))(q, x), p)
        # numpy: a tensor in a queue is shared memory that dies with the
        # worker
        out.put((rank, y.numpy(), aux.numpy(),
                 map_params(g, lambda t: t.numpy())))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)],
                         ids=["f-sharded", "batch-sharded"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_two_gloo_ranks_f_sharded_match_unsharded(arch, shape, tmp_path):
    cfg = get_config(arch)
    _, p, x_np = _inputs(arch, B=shape[0], S=8)
    x = torch.from_numpy(x_np)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, str(tmp_path / "store"), arch, shape, p,
                               x, out))
             for r in range(2)]
    for proc in procs:
        proc.start()
    got = {r: (torch.from_numpy(y), torch.from_numpy(a),
               map_params(g, torch.from_numpy))
           for r, y, a, g in (out.get(timeout=120) for _ in procs)}
    for proc in procs:
        proc.join(timeout=60)
        assert not proc.is_alive() and proc.exitcode == 0
    y, aux = moe.moe_apply(p, x, cfg)
    _, g = value_and_grad(lambda q: _loss(
        lambda q_, x_: moe.moe_apply(q_, x_, cfg))(q, x), p)
    for r in range(2):
        assert_close(got[r][0], y, f"{arch} y rank {r}")
        assert_close(got[r][1], aux, f"{arch} aux rank {r}")
    # every leaf's grad whole on both ranks: an f-sharded leaf's slices
    # gathered, a partial sum over the batch reduced
    for path, _ in moe._sharded_dims(cfg):
        for r in range(2):
            assert_close(_node(got[r][2], path), _node(g, path),
                         f"{path} rank {r}")


def test_dtensor_path_param_grads_are_partial_over_the_batch(group):
    """DTensor inputs (the dry run) on the 16x16 fake mesh, each param
    laid out as the local body takes it: its gradient is a partial sum
    over "data" (its broadcast over the batch transposed), still split
    over "model" where the param is; x's keeps its batch split."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch import sharding

    arch = "deepseek-v2-lite-16b-reduced"
    cfg = get_config(arch)
    m = mesh.make_production_mesh()
    with FakeTensorMode():
        p = moe.init_moe(torch.Generator(), cfg, torch.float32,
                         torch.device("cpu"))
        for path, dim in moe._sharded_dims(cfg):
            *head, last = path
            node = _node(p, head)
            node[last] = sharding.shard(node[last], (
                Replicate(), Replicate() if dim is None else Shard(dim)),
                m).requires_grad_()
        x = sharding.shard(torch.empty(32, 8, cfg.d_model),
                           (Shard(0), Replicate()), m).requires_grad_()
        y, aux = moe.moe_apply_sharded(p, x, cfg, m)
        ((y ** 2).sum() + aux).backward()
    for path, dim in moe._sharded_dims(cfg):
        want = (Partial(), Shard(dim) if dim is not None else Replicate())
        assert _node(p, path).grad.placements == want, path
    assert x.grad.placements == (Shard(0), Replicate())


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape,multi_pod", [("train_4k", False),
                                             ("decode_32k", True)],
                         ids=["train_4k-16x16", "decode_32k-2x16x16"])
def test_dryrun_shard_map_moves_fewer_bytes(shape, multi_pod, group):
    arch = "deepseek-v2-lite-16b-reduced"
    recs = {impl: dryrun.dryrun_one(arch, shape, multi_pod, verbose=False,
                                    rt_overrides={"moe_impl": impl})
            for impl in ("gspmd", "shard_map")}
    assert not dist.is_initialized()
    g, s = recs["gspmd"], recs["shard_map"]
    assert (g["moe_impl"], s["moe_impl"]) == ("gspmd", "shard_map")
    assert 0 < s["collective_total"] < g["collective_total"]
    assert s["flops"] > 0 and g["flops"] > 0
    assert any(k.startswith("scatter into a per-sequence buffer")
               for k in g["reshards"])
    assert not any(k.startswith("scatter") for k in s["reshards"])

"""The port's mesh tools against the JAX package's.

Identical, no tolerance:

* ``SHAPES`` and ``get_shape``;
* the new ``RuntimeOptions`` fields' defaults;
* ``runtime_for``'s ``kv_mult``, ``remat``, ``window`` and
  ``absorbed_mla`` for the ten architectures x four shapes at model
  axis 16 and 1 (the port's ``impl`` is ``"torch"`` where the
  reference's is ``"xla"``);
* ``param_spec`` for every leaf of the ten full-size param trees (the
  JAX side from ``jax.eval_shape``, the port's from ``FakeTensorMode``,
  leaves matched by their flat path keys) at model sizes 1 and 16;
* ``cache_spec`` for every cache leaf at decode_32k and long_500k on the
  16x16 and 2x16x16 meshes (the reference reads only ``.shape`` and
  ``.axis_names`` of its mesh, so a stand-in object serves it; the
  port's is the production ``DeviceMesh`` over the fake backend);
* ``input_specs``' shapes and dtypes, leaf by leaf, for 10 x 4 (the
  port's cache keeps ``idx`` a Python int, not a scalar tensor);
* ``batch_axes``, ``model_axis_size``, ``data_axis_size`` on both
  production meshes.

And the meshes themselves: shapes and axis names, a default group of
another size refused, the one-rank host mesh (gloo on the CPU), specs
turned into placements.  Every test that makes a process group tears it
down, also when it fails (``group`` fixture).

``remat``: with ``RuntimeOptions(remat=True)`` each layer (qwen3), each
super-block (zamba2, the 5-layer schedule of two invocations and a
tail) and each encoder and decoder layer (seamless) runs again in the
backward pass, and the loss, every grad and an AdamW step are bitwise
those without it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.configs import shapes as jshapes
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.launch import specs as jsp
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs import shapes
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh, sharding, specs
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.api import get_model
from repro_torch.models.ecg_resnext import leaves
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.training.data import audio_frames, lm_batches
from repro_torch.training.optimizer import AdamW, constant_schedule
from repro_torch.training.train_loop import (lm_loss, make_train_step,
                                             value_and_grad)

SHAPE_NAMES = sorted(jshapes.SHAPES)
torch.set_num_threads(1)


@pytest.fixture
def group():
    """Tears down whatever process group the test made."""
    mesh.teardown()
    yield
    mesh.teardown()


def _j_leaves(tree):
    """{flat path keys: leaf} of a JAX tree (the reference's path keys)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_keys(p): leaf for p, leaf in flat}


def _t_leaves(tree):
    out = {}
    sharding._map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


def _p_leaves(tree, path=()):
    """{flat path keys: placements} of a tree of placement tuples."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _p_leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _p_leaves(sub, path + (str(i),)).items()}
    return {path: tree}


def _stand_in(multi_pod: bool):
    """What the reference's ``cache_spec`` reads of a mesh."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


# ------------------------------------------------------------- shapes
def test_shapes_identical():
    assert sorted(shapes.SHAPES) == SHAPE_NAMES
    for name in SHAPE_NAMES:
        assert dataclasses.asdict(shapes.get_shape(name)) \
            == dataclasses.asdict(jshapes.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        shapes.get_shape("train_8k")


def test_runtime_options_new_fields_have_reference_defaults():
    j, t = JRuntimeOptions(), RuntimeOptions()
    for f in ("remat", "scan_unroll", "moe_impl", "mesh", "kv_mult",
              "window", "absorbed_mla", "capacity_factor", "attn_chunk"):
        assert getattr(t, f) == getattr(j, f), f
    with pytest.raises(ValueError, match="moe_impl"):
        RuntimeOptions(moe_impl="expert_parallel")


@pytest.mark.parametrize("axis", [16, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_runtime_for_matches_reference(arch, axis):
    for name in SHAPE_NAMES:
        j = jsp.runtime_for(j_get_config(arch), jshapes.get_shape(name),
                            axis, absorbed_mla=True)
        t = specs.runtime_for(get_config(arch), shapes.get_shape(name),
                              axis, absorbed_mla=True)
        for f in ("kv_mult", "remat", "window", "absorbed_mla"):
            assert getattr(t, f) == getattr(j, f), (arch, name, axis, f)
        assert (t.impl, t.dtype, j.dtype) == ("torch", torch.bfloat16,
                                              jnp.bfloat16)


# ------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_matches_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    train = jshapes.get_shape("train_4k")
    j_leaves = _j_leaves(jsp.param_shapes(
        jcfg, jsp.runtime_for(jcfg, train, 16)))
    t_leaves = _t_leaves(specs.param_shapes(
        cfg, specs.runtime_for(cfg, shapes.get_shape("train_4k"), 16)))
    assert sorted(t_leaves) == sorted(j_leaves)
    for path, leaf in j_leaves.items():
        assert tuple(t_leaves[path].shape) == leaf.shape, path
        for size in (1, 16):
            want = tuple(jshd.param_spec(path, leaf.shape, jcfg, size))
            got = sharding.param_spec(path, tuple(t_leaves[path].shape),
                                      cfg, size)
            assert got == want, (path, size)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_matches_reference(arch, multi_pod, group):
    prod = mesh.make_production_mesh(multi_pod=multi_pod)
    jm = _stand_in(multi_pod)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for name in ("decode_32k", "long_500k"):
        js, ts = jshapes.get_shape(name), shapes.get_shape(name)
        j_leaves = _j_leaves(jsp.cache_shapes(
            jcfg, jsp.runtime_for(jcfg, js, 16), js))
        t_leaves = _t_leaves(specs.cache_shapes(
            cfg, specs.runtime_for(cfg, ts, 16), ts))
        assert sorted(t_leaves) == sorted(k for k in j_leaves
                                          if k != ("idx",))
        for path, leaf in t_leaves.items():
            shp = tuple(leaf.shape)
            assert shp == j_leaves[path].shape, path
            for dp_only in (False, True):
                want = tuple(jshd.cache_spec(path, shp, jm, js.global_batch,
                                             dp_only))
                got = sharding.cache_spec(path, shp, prod, ts.global_batch,
                                          dp_only)
                assert got == want, (name, path, dp_only)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for name in SHAPE_NAMES:
        js, ts = jshapes.get_shape(name), shapes.get_shape(name)
        j_args = jsp.input_specs(jcfg, js, jsp.runtime_for(jcfg, js, 16))
        t_args = specs.input_specs(cfg, ts, specs.runtime_for(cfg, ts, 16))
        assert len(j_args) == len(t_args)
        if js.kind == "train":                  # AdamWState(step, mu, nu)
            j_args = (j_args[0], *j_args[1], j_args[2])
            t_args = (t_args[0], *t_args[1], t_args[2])
        for ja, ta in zip(j_args, t_args):
            jl, tl = _j_leaves(ja), _t_leaves(ta)
            if js.kind == "decode" and ja is j_args[1]:
                jl.pop(("idx",))                # an int in the port
            assert sorted(tl) == sorted(jl), name
            for path, leaf in jl.items():
                assert tuple(tl[path].shape) == leaf.shape, (name, path)
                assert _dtype_name(tl[path].dtype) == str(leaf.dtype), \
                    (name, path)


# ------------------------------------------------------------- meshes
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_production_mesh_matches_reference(multi_pod, group):
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    jm = _stand_in(multi_pod)
    assert m.mesh_dim_names == jm.axis_names
    assert tuple(m.mesh.shape) == tuple(jm.shape.values())
    assert dist.get_backend() == "fake"
    assert mesh.batch_axes(m) == jmesh.batch_axes(jm)
    assert mesh.model_axis_size(m) == jmesh.model_axis_size(jm) == 16
    assert mesh.data_axis_size(m) == jmesh.data_axis_size(jm)
    # the same group serves a second mesh of its size, not another size
    assert mesh.make_production_mesh(multi_pod=multi_pod).mesh.shape \
        == m.mesh.shape
    with pytest.raises(RuntimeError, match="teardown"):
        mesh.make_production_mesh(multi_pod=not multi_pod)
    with pytest.raises(RuntimeError, match="teardown"):
        mesh.make_host_mesh("cpu")
    mesh.teardown()
    assert not dist.is_initialized()


def test_host_mesh_is_one_gloo_rank(group):
    m = mesh.make_host_mesh("cpu")
    assert m.mesh_dim_names == ("data", "model")
    assert tuple(m.mesh.shape) == (1, 1)
    assert (dist.get_backend(), dist.get_world_size()) == ("gloo", 1)
    t = torch.arange(4.0)
    dist.all_reduce(t, group=m.get_group("model"))
    assert torch.equal(t, torch.arange(4.0))


def test_placements_split_major_to_minor(group):
    m = mesh.make_production_mesh(multi_pod=True)
    assert sharding.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((), m) == (Replicate(),) * 3
    assert sharding.batch_input_sharding(m, 256, 2) == (
        Shard(0), Shard(0), Replicate())
    assert sharding.batch_input_sharding(m, 1, 1) == (Replicate(),) * 3
    # rank 0's chunk: the first of 32 along dim 0, of 16 along dim 2
    t = torch.arange(64 * 3 * 32).reshape(64, 3, 32)
    local = sharding.local_shard(t, (Shard(0), Shard(0), Shard(2)), m)
    assert torch.equal(local, t[:2, :, :2])
    d = sharding.shard(t, (Shard(0), Shard(0), Shard(2)), m)
    assert tuple(d.shape) == (64, 3, 32) and d.to_local().shape == (2, 3, 2)


def test_partition_params_places_every_leaf(group):
    cfg = get_config("qwen3-4b")
    m = mesh.make_production_mesh()
    rt = specs.runtime_for(cfg, shapes.get_shape("train_4k"), 16)
    params = specs.param_shapes(cfg, rt)
    place = sharding.partition_params(params, cfg, m)
    flat_p, flat_t = _p_leaves(place), _t_leaves(params)
    assert sorted(flat_p) == sorted(flat_t)
    seg = ("segments", "0")
    assert flat_p[seg + ("attn", "wq", "w")] == (Replicate(), Shard(2))
    assert flat_p[seg + ("mlp", "down", "w")] == (Replicate(), Shard(1))
    assert flat_p[("embed", "table")] == (Replicate(), Shard(0))
    assert flat_p[("final_norm", "scale")] == (Replicate(), Replicate())
    # as in the reference, model_size=1 passes every divisibility guard,
    # so the specs still name "model" (``_div(shape, d, 1)`` holds)
    assert sharding.partition_params(params, cfg, m, model_size=1)[
        "segments"][0]["attn"]["wq"]["w"] == (Replicate(), Shard(2))


# ------------------------------------------------------------- remat
# (arch, config overrides, the function remat wraps, calls a forward)
REMAT = [
    ("qwen3-4b-reduced", {}, transformer, "_apply_block", 2),
    # two invocations of the shared block and a tail layer
    ("zamba2-7b-reduced", {"num_layers": 5, "shared_attn_every": 2},
     hybrid, "_super_block", 2),
    ("seamless-m4t-medium-reduced", {}, encdec, "_dec_block", 2),
    ("seamless-m4t-medium-reduced", {}, encdec, "_enc_block", 2)]


@pytest.mark.parametrize("arch,over,mod,fn,calls", REMAT,
                         ids=[f"{r[0]}-{r[3]}" for r in REMAT])
def test_remat_recomputes_and_keeps_grads_bitwise(arch, over, mod, fn,
                                                  calls, monkeypatch):
    cfg = dataclasses.replace(get_config(arch), **over)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg,
                        RuntimeOptions(), "cpu")
    b = next(lm_batches(cfg.vocab_size, 2, 16, seed=0))
    if cfg.n_prefix_tokens and cfg.frontend_dim:
        b["prefix_embeds"] = audio_frames(2, cfg.n_prefix_tokens,
                                          cfg.frontend_dim, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    seen = []
    real = getattr(mod, fn)
    monkeypatch.setattr(mod, fn, lambda *a, **k: seen.append(1)
                        or real(*a, **k))
    out, n_calls = {}, {}
    for remat in (False, True):
        seen.clear()
        rt = RuntimeOptions(impl="torch", remat=remat)
        out[remat] = value_and_grad(
            lambda p: lm_loss(p, batch, cfg, rt, model), params)
        n_calls[remat] = len(seen)
        opt = AdamW(lr=constant_schedule(3e-4))
        out[remat] += (make_train_step(cfg, rt, opt)(
            params, opt.init(params), batch),)
    # recomputed in the backward pass: each block runs twice
    assert n_calls[True] == calls * n_calls[False] > 0
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert torch.equal(s0[2], s1[2]) and all(
        torch.equal(a, b) for a, b in zip(leaves(s0[0]), leaves(s1[0])))

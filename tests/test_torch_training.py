"""The port's training path against the JAX package's, on the same seeds.

* ``training/data.py``: every function bitwise the reference's;
* ``softmax_xent``, ``AdamW.update``, ``global_norm`` and the schedules
  within the one tolerance of ``repro_torch.testing``;
* checkpoints bitwise both ways (port save -> JAX restore and back) and
  the committed ``results/zoo_cache`` members bitwise the JAX restore;
* the ECG loss and every grad, the first steps of ``train_ecg_model``
  on the reference's minibatch draws, and ``ecg_predict_proba``;
* for five LM families (dense, VLM, SSM, MoE with GQA, MoE with MLA),
  ``lm_loss`` and every grad and one ``make_train_step`` step;
* counterparts of ``tests/test_training.py``'s tests inside the port.

JAX params are carried across with ``params_from_numpy`` (the two RNGs
differ).  The reference trains through ``impl="xla"``; the port trains
through the plain versions (``impl="torch"``) on the CPU here.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.ecg_zoo import zoo_specs as jzoo_specs
from repro.configs.registry import get_config as jget_config
from repro.models import ecg_resnext as jecg
from repro.models.api import get_model as jget_model
from repro.models.layers import softmax_xent as jsoftmax_xent
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import train as tlaunch
from repro_torch.models import ecg_resnext as tecg
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ecg_resnext import leaves, map_params
from repro_torch.models.layers import softmax_xent
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_bitwise, assert_close
from repro_torch.training import checkpoint, data
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tl

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL_ZOO = sorted(glob.glob(os.path.join(
    ROOT, "results", "zoo_cache", "r1_p12_c6_s3_t60_seed0_*.npz")))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_tree(params, loss_fn):
    """(loss, grads) of ``loss_fn`` at ``params`` by plain autograd."""
    p = map_params(params, lambda t: t.detach().clone().requires_grad_())
    loss = loss_fn(p)
    loss.backward()
    return loss, map_params(p, lambda t: t.grad)


def _hold_trees(got, want, what):
    g, w = list(leaves(got)), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, (what, i)
        assert_close(a, np.asarray(b), f"{what}: leaf {i}")


# ------------------------------------------------------------------ data
def test_sample_patient_bitwise():
    for label in (0, 1):
        for atyp in (0.0, 0.4):
            got = data.sample_patient(np.random.default_rng(3), label, atyp)
            want = jdata.sample_patient(np.random.default_rng(3), label,
                                        atyp)
            for f in dataclasses.fields(want):
                g, w = getattr(got, f.name), getattr(want, f.name)
                assert_bitwise(np.asarray(g), np.asarray(w), f.name)


def test_ecg_beat_and_clips_bitwise():
    t = np.linspace(0.0, 1.0, 257, endpoint=False)
    assert_bitwise(data._ecg_beat(t, 0.1), jdata._ecg_beat(t, 0.1))
    pp = jdata.sample_patient(np.random.default_rng(5), 0, 0.2)
    for fn, jfn, args in ((data.ecg_clip, jdata.ecg_clip, (4, 250)),
                          (data.vitals_clip, jdata.vitals_clip, (6,)),
                          (data.labs_sample, jdata.labs_sample, ())):
        assert_bitwise(fn(np.random.default_rng(9), pp, *args),
                       jfn(np.random.default_rng(9), pp, *args),
                       fn.__name__)


def test_icu_dataset_and_split_bitwise():
    got = data.make_icu_dataset(5, 2, seed=1, seconds=2, ambiguity=0.5)
    want = jdata.make_icu_dataset(5, 2, seed=1, seconds=2, ambiguity=0.5)
    assert set(got) == set(want)
    for k in want:
        assert_bitwise(got[k], want[k], k)
    for g, w in zip(data.split_by_patient(got, 2),
                    jdata.split_by_patient(want, 2)):
        for k in w:
            assert_bitwise(g[k], w[k], k)


def test_lm_batches_and_audio_frames_bitwise():
    got = data.lm_batches(1000, 3, 17, seed=4, zipf_a=1.3)
    want = jdata.lm_batches(1000, 3, 17, seed=4, zipf_a=1.3)
    for _ in range(3):
        g, w = next(got), next(want)
        for k in ("tokens", "labels"):
            assert_bitwise(g[k], w[k], k)
    assert_bitwise(data.audio_frames(2, 5, 7, seed=2),
                   jdata.audio_frames(2, 5, 7, seed=2))


def test_icu_dataset_structure():
    """``tests/test_training.py::test_icu_dataset_structure`` in the port."""
    d = data.make_icu_dataset(n_patients=4, clips_per_patient=3, seed=0,
                              seconds=2)
    assert d["ecg"].shape == (12, 3, 500)
    assert d["vitals"].shape == (12, 7, 2)
    assert d["labs"].shape == (12, 8)
    tr, va = data.split_by_patient(d, holdout=1)
    assert set(np.unique(va["patient"])) == {3}
    assert not set(np.unique(tr["patient"])) & {3}


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_softmax_xent_matches_jax(mask):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    if mask == "some":
        labels[0, 1:3] = -1
        labels[1, 4] = -1
    elif mask == "all":
        labels[:] = -1
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jsoftmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    assert_close(got, np.asarray(want), mask)
    if mask == "all":
        assert float(got) == 0.0


def test_softmax_xent_masking():
    """``tests/test_training.py::test_softmax_xent_masking`` in the port."""
    logits = torch.tensor([[[2.0, 0.0], [0.0, 2.0]]])
    labels = torch.tensor([[0, -1]])           # second token masked
    l1 = softmax_xent(logits, labels)
    l2 = softmax_xent(logits[:, :1], labels[:, :1])
    assert float(l1) == pytest.approx(float(l2))


# ------------------------------------------------------------- optimizer
def _opt_tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((4, 3)) * scale)
                  .astype(np.float32)},
            "b": [(rng.standard_normal((5,)) * scale).astype(np.float32),
                  (rng.standard_normal((2, 2)) * scale).astype(np.float32)]}


# (grad scale: clipping active at 5.0, inactive at 0.01; updates taken)
@pytest.mark.parametrize("gscale,steps", [(5.0, 1), (0.01, 1), (5.0, 5),
                                          (0.01, 5)],
                         ids=["clip-step1", "noclip-step1", "clip-step5",
                              "noclip-step5"])
def test_adamw_update_matches_jax(gscale, steps):
    jo = jopt.AdamW(lr=jopt.cosine_schedule(0.1, 2, 10), weight_decay=0.1)
    to = topt.AdamW(lr=topt.cosine_schedule(0.1, 2, 10), weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, _opt_tree(0, 1.0))
    tp = params_from_numpy(_opt_tree(0, 1.0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = _opt_tree(10 + i, gscale)
        clipped = float(jopt.global_norm(g)) > jo.grad_clip
        assert clipped == (gscale > 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(params_from_numpy(g), ts, tp)
    assert int(ts.step) == int(js.step) == steps
    assert ts.step.dtype == torch.int32
    _hold_trees(tp, jp, "params")
    _hold_trees(ts.mu, js.mu, "mu")
    _hold_trees(ts.nu, js.nu, "nu")


def test_global_norm_and_schedules_match_jax():
    g = _opt_tree(1, 3.0)
    assert_close(topt.global_norm(params_from_numpy(g)),
                 np.asarray(jopt.global_norm(g)))
    for t_lr, j_lr in ((topt.cosine_schedule(2e-3, 10, 100, floor=0.2),
                        jopt.cosine_schedule(2e-3, 10, 100, floor=0.2)),
                       (topt.constant_schedule(3e-4),
                        jopt.constant_schedule(3e-4))):
        for step in (0, 5, 10, 55, 100, 120):
            assert_close(t_lr(torch.tensor(step, dtype=torch.int32)),
                         np.asarray(j_lr(jnp.asarray(step, jnp.int32))),
                         f"step {step}")


def test_adamw_reduces_quadratic():
    """``tests/test_training.py::test_adamw_reduces_quadratic``."""
    opt = topt.AdamW(lr=topt.constant_schedule(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.2


def test_grad_clip():
    """``tests/test_training.py::test_grad_clip``."""
    opt = topt.AdamW(lr=topt.constant_schedule(0.1), grad_clip=1.0)
    g = {"a": torch.full((4,), 100.0)}
    assert float(topt.global_norm(g)) == pytest.approx(200.0)
    params = {"a": torch.zeros((4,))}
    state = opt.init(params)
    p2, _ = opt.update(g, state, params)
    assert bool(torch.isfinite(p2["a"]).all())


def test_cosine_schedule_shape():
    """``tests/test_training.py::test_cosine_schedule_shape``."""
    lr = topt.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1)


def test_update_runs_without_grad_and_leaves_its_arguments():
    opt = topt.AdamW(lr=topt.constant_schedule(0.1))
    params = {"w": torch.ones(3, requires_grad=True)}
    state = opt.init(params)
    new, new_state = opt.update({"w": torch.ones(3)}, state, params)
    assert not new["w"].requires_grad
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert torch.equal(params["w"].detach(), torch.ones(3))


# ------------------------------------------------------------ checkpoint
def test_committed_members_restore_bitwise():
    assert len(SMALL_ZOO) == 12
    specs = {s.name: s for s in zoo_specs(reduced=True, input_len=750)}
    for i, path in enumerate(SMALL_ZOO):
        name = path.rsplit("seed0_", 1)[1][:-len(".npz")]
        spec = specs[name]
        want = jck.restore(path, jecg.init_ecg(jax.random.PRNGKey(i), spec))
        got = checkpoint.restore(path, tecg.init_ecg(
            spec, torch.Generator().manual_seed(i)))
        g, w = list(leaves(got)), jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert_bitwise(a, np.asarray(b), name)


def _trees(kind):
    """(JAX tree, the same tree in the port) for an ECG member and an LM."""
    if kind == "ecg":
        spec = jzoo_specs(reduced=True, input_len=250)[3]
        jt = jecg.init_ecg(jax.random.PRNGKey(1), spec)
    else:
        cfg = jget_config("smollm-360m-reduced")
        jt = jget_model(cfg).init(jax.random.PRNGKey(1), cfg,
                                  JRuntimeOptions())
    return jt, params_from_numpy(_np(jt))


@pytest.mark.parametrize("kind", ["ecg", "lm"])
def test_checkpoints_cross_bitwise(kind, tmp_path):
    jt, tt = _trees(kind)
    # different values than the templates, so a restore must read them
    tt = map_params(tt, lambda t: t * 3 + 1)
    jt2 = jax.tree.map(lambda a: a * 3 + 1, jt)
    port = str(tmp_path / "port.npz")
    checkpoint.save(port, tt, {"by": "port"})
    got = jck.restore(port, jt)
    for a, b in zip(jax.tree.leaves(got), leaves(tt)):
        assert_bitwise(np.asarray(a), b, "port save -> JAX restore")
    ref = str(tmp_path / "ref.npz")
    jck.save(ref, jt2, {"by": "jax"})
    back = checkpoint.restore(ref, params_from_numpy(_np(jt)))
    for a, b in zip(leaves(back), jax.tree.leaves(jt2)):
        assert_bitwise(a, np.asarray(b), "JAX save -> port restore")
    assert checkpoint.load_metadata(port) == jck.load_metadata(port) == {
        "by": "port", "n_arrays": len(jax.tree.leaves(jt))}
    assert checkpoint.load_metadata(ref)["by"] == "jax"
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_roundtrip_and_errors(tmp_path):
    """``tests/test_training.py::test_checkpoint_roundtrip`` and
    ``test_checkpoint_shape_mismatch_raises`` in the port, and the
    missing key."""
    tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)},
            "c": [torch.ones(4), torch.zeros(2, 2)]}
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, tree, {"step": 7})
    out = checkpoint.restore(path, tree)
    for a, b in zip(leaves(tree), leaves(out)):
        assert_bitwise(a, b)
    assert checkpoint.load_metadata(path) == {"step": 7, "n_arrays": 3}
    with pytest.raises(ValueError):
        checkpoint.restore(path, {**tree, "a": {"b": torch.zeros(3, 3)}})
    with pytest.raises(KeyError):
        checkpoint.restore(path, {**tree, "d": torch.zeros(1)})


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the old file and no tmp file."""
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"w": torch.ones(2)})

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.np, "savez", boom)
    with pytest.raises(OSError):
        checkpoint.save(path, {"w": torch.zeros(2)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz",
                                                          "ck.npz.json"]
    assert_bitwise(checkpoint.restore(path, {"w": torch.zeros(2)})["w"],
                   torch.ones(2))


# ------------------------------------------------------------ ECG train
ECG_SPECS = zoo_specs(reduced=True, input_len=250)


@pytest.mark.parametrize("i", [0, 3], ids=[ECG_SPECS[0].name,
                                           ECG_SPECS[3].name])
def test_ecg_loss_and_grads_match_jax(i):
    spec = ECG_SPECS[i]
    jp = jecg.init_ecg(jax.random.PRNGKey(i), spec)
    rng = np.random.default_rng(i)
    x = rng.standard_normal((6, spec.input_len, 1)).astype(np.float32)
    y = rng.integers(0, 2, 6).astype(np.int32)
    lw, gw = jax.jit(jax.value_and_grad(
        lambda p: jtl.ecg_loss(p, x, y, spec)))(jp)
    lg, gg = _grad_tree(params_from_numpy(_np(jp)), lambda p: tl.ecg_loss(
        p, torch.from_numpy(x), torch.from_numpy(y), spec))
    assert_close(lg, np.asarray(lw), "loss")
    _hold_trees(gg, gw, "grads")


@pytest.fixture(scope="module")
def cohort():
    d = data.make_icu_dataset(n_patients=8, clips_per_patient=5, seed=0,
                              seconds=1)
    return data.split_by_patient(d, holdout=2)


def test_train_ecg_model_matches_jax(cohort, monkeypatch):
    """The port's trainer from the reference's initial params: the same
    minibatch draws, the losses of the first 5 steps and the params
    after them within the tolerance."""
    tr, _ = cohort
    spec = ECG_SPECS[3]
    x, y = tr["ecg"][:, 1, :], tr["label"]
    jinit = jecg.init_ecg(jax.random.PRNGKey(4), spec)
    monkeypatch.setattr(tl, "init_ecg", lambda s, gen, dev: params_from_numpy(
        _np(jinit), dev))
    jp, jl = jtl.train_ecg_model(spec, x, y, steps=5, batch=16, seed=4)
    tp, tl_losses = tl.train_ecg_model(spec, x, y, steps=5, batch=16,
                                       seed=4, device="cpu")
    assert_close(np.asarray(tl_losses), np.asarray(jl), "losses")
    _hold_trees(tp, jp, "params after 5 steps")
    assert not any(t.requires_grad for t in leaves(tp))


def test_ecg_predict_proba_matches_jax():
    spec = {s.name: s for s in zoo_specs(reduced=True,
                                         input_len=750)}["lead2_w16_b4"]
    path = [p for p in SMALL_ZOO if p.endswith("_lead2_w16_b4.npz")][0]
    jp = jck.restore(path, jecg.init_ecg(jax.random.PRNGKey(0), spec))
    tp = checkpoint.restore(path, tecg.init_ecg(
        spec, torch.Generator().manual_seed(0)))
    x = np.random.default_rng(2).standard_normal(
        (300, spec.input_len)).astype(np.float32)  # two passes of 256
    got = tl.ecg_predict_proba(tp, x, spec)
    want = jtl.ecg_predict_proba(jp, x, spec)
    assert got.shape == (300,)
    assert_close(got, want)


def test_ecg_model_learns(icu_data, monkeypatch):
    """``tests/test_training.py::test_ecg_model_learns`` in the port: from
    the reference's initial params (PRNGKey(0)) its own assertion holds.
    From the port's own seed-0 init the first minibatch's loss is
    already near ln 2 (0.660 against the last step's 0.663), so there the
    mean of the last 5 steps is held below the mean of the first 5."""
    tr, va = icu_data
    spec = zoo_specs(reduced=True, input_len=750)[0]
    x, y = tr["ecg"][:, 0, :], tr["label"]
    params, losses = tl.train_ecg_model(spec, x, y, steps=60, seed=0,
                                        device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    proba = tl.ecg_predict_proba(params, va["ecg"][:, 0, :], spec)
    assert proba.shape == (len(va["label"]),)
    assert np.all((proba >= 0) & (proba <= 1))
    jinit = _np(jecg.init_ecg(jax.random.PRNGKey(0), spec))
    monkeypatch.setattr(tl, "init_ecg", lambda s, gen, dev: params_from_numpy(
        jinit, dev))
    _, losses = tl.train_ecg_model(spec, x, y, steps=60, seed=0,
                                   device="cpu")
    assert losses[-1] < losses[0]


# ------------------------------------------------------------- LM train
LM_ARCHS = ["smollm-360m-reduced", "internvl2-26b-reduced",
            "mamba2-2.7b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
            "deepseek-v2-lite-16b-reduced", "zamba2-7b-reduced",
            "seamless-m4t-medium-reduced"]
_LM = {}


def _lm_batch(cfg, B=2, S=16):
    b = next(data.lm_batches(cfg.vocab_size, B, S, seed=0))
    if cfg.n_prefix_tokens and cfg.frontend_dim:
        b["prefix_embeds"] = data.audio_frames(B, cfg.n_prefix_tokens,
                                               cfg.frontend_dim, seed=0)
        if cfg.family == "vlm":
            b["labels"] = np.concatenate(
                [np.full((B, cfg.n_prefix_tokens), -1, np.int32),
                 b["labels"]], axis=1)
    return b


def _lm(arch):
    """The JAX package's loss, grads and one train step from its own init
    on one batch (computed once per arch for the two tests below)."""
    if arch not in _LM:
        cfg_j, rt_j = jget_config(arch), JRuntimeOptions()
        params_j = jget_model(cfg_j).init(jax.random.PRNGKey(0), cfg_j,
                                          rt_j)
        b = _lm_batch(get_config(arch))
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtl.lm_loss(p, bj, cfg_j, rt_j)))(params_j)
        opt = jopt.AdamW(lr=jopt.constant_schedule(3e-4))
        stepped, _, step_loss = jax.jit(jtl.make_train_step(
            cfg_j, rt_j, opt))(params_j, opt.init(params_j), bj)
        _LM[arch] = dict(params=_np(params_j), batch=b, loss=loss,
                         grads=grads, stepped=stepped, step_loss=step_loss)
    return _LM[arch]


def _min_route_gap(cfg, params, batch):
    """The smallest gap, over every MoE layer and token, between the
    k-th and (k+1)-th router probabilities of the port's forward: a
    relative difference of ~1e-7 between the packages can flip a top-k
    choice only where this is under 1e-5 (``testing.py``)."""
    inputs = []
    transformer.forward(params, torch.from_numpy(batch["tokens"]), cfg,
                        RuntimeOptions(), moe_inputs=inputs)
    (si, n), = [(i, n) for i, (bt, n, _) in
                enumerate(transformer.segments(cfg)) if bt == "attn_moe"]
    router = params["segments"][si]["mlp"]["router"]
    K = cfg.moe.top_k
    gap = np.inf
    for layer, h in enumerate(inputs):
        probs = torch.softmax((h @ router[layer]).float(), dim=-1)
        top = torch.topk(probs, K + 1, dim=-1).values
        gap = min(gap, float((top[..., K - 1] - top[..., K]).min()))
    return gap


def _near_tie(arch, cfg, params, batch) -> bool:
    """True (and a warning naming the gap) where a MoE routing near-tie
    could flip a choice between the packages: such a flip is reported,
    not failed (``testing.py``)."""
    if not cfg.moe:
        return False
    gap = _min_route_gap(cfg, params, batch)
    if gap < 1e-5:
        warnings.warn(f"{arch}: routing near-tie, gap {gap:.2e}: a flip "
                      "between the packages is possible; not held")
    return gap < 1e-5


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    ref = _lm(arch)
    cfg = get_config(arch)
    params = params_from_numpy(ref["params"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    if _near_tie(arch, cfg, params, ref["batch"]):
        return
    loss, grads = _grad_tree(params, lambda p: tl.lm_loss(
        p, batch, cfg, RuntimeOptions(impl="torch")))
    assert_close(loss, np.asarray(ref["loss"]), "loss")
    _hold_trees(grads, ref["grads"], "grads")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_matches_jax(arch):
    ref = _lm(arch)
    cfg = get_config(arch)
    opt = topt.AdamW(lr=topt.constant_schedule(3e-4))
    params = params_from_numpy(ref["params"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    if _near_tie(arch, cfg, params, ref["batch"]):
        return
    step = tl.make_train_step(cfg, RuntimeOptions(), opt)
    new, state, loss = step(params, opt.init(params), batch)
    assert int(state.step) == 1
    assert_close(loss, np.asarray(ref["step_loss"]), "loss")
    _hold_trees(new, ref["stepped"], "params after one step")
    assert not any(t.requires_grad for t in leaves(new))


def test_serve_makers_match_the_model_and_need_no_grad():
    """``make_serve_prefill`` / ``make_serve_step`` keep the caller's
    ``rt`` and run without grad: on params that require grad (as a
    training loop might hand them over) they give the model's logits."""
    cfg = get_config("smollm-360m-reduced")
    rt = RuntimeOptions()
    params = transformer.init_lm(torch.Generator().manual_seed(1), cfg, rt,
                                 "cpu")
    toks = torch.from_numpy(_lm_batch(cfg)["tokens"])
    want, cache = transformer.prefill(params, toks, cfg, rt,
                                      max_len=toks.shape[1] + 1)
    step_want, _ = transformer.decode_step(params, cache, toks[:, 0], cfg,
                                           rt)
    rg = map_params(params, lambda t: t.clone().requires_grad_())
    got = tl.make_serve_prefill(cfg, rt)(rg, {"tokens": toks})
    assert not got.requires_grad
    assert_bitwise(got, want)
    _, cache = transformer.prefill(params, toks, cfg, rt,
                                   max_len=toks.shape[1] + 1)
    step_got, _ = tl.make_serve_step(cfg, rt)(rg, cache, toks[:, 0])
    assert_bitwise(step_got, step_want)


def test_train_step_with_cuda_impl_hits_the_guard():
    cfg = get_config("smollm-360m-reduced")
    opt = topt.AdamW(lr=topt.constant_schedule(3e-4))
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                                 RuntimeOptions(), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg).items()}
    step = tl.make_train_step(cfg, RuntimeOptions(impl="cuda"), opt)
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt.init(params), batch)


def test_lm_loss_decreases():
    """``tests/test_training.py::test_lm_loss_decreases`` in the port."""
    cfg = get_config("smollm-360m").reduced()
    _, losses = tl.train_lm(cfg, RuntimeOptions(),
                            data.lm_batches(cfg.vocab_size, 8, 64, seed=0),
                            steps=25, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_launch_train_runs_and_checkpoint_restores(tmp_path, capsys):
    ck = str(tmp_path / "lm.npz")
    assert tlaunch.main(["--arch", "smollm-360m-reduced", "--steps", "3",
                         "--device", "cpu", "--checkpoint", ck]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads([l for l in out if l.startswith("{")][0])
    assert set(summary) >= {"first_loss", "last_loss", "wall_s",
                            "steps_per_s"}
    assert np.isfinite([summary["first_loss"], summary["last_loss"]]).all()
    cfg = get_config("smollm-360m-reduced")
    init = transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                               RuntimeOptions(), "cpu")
    restored = checkpoint.restore(ck, init)
    moved = [not torch.equal(a, b) for a, b in zip(leaves(restored),
                                                   leaves(init))]
    assert any(moved)
    assert checkpoint.load_metadata(ck) == {
        "arch": "smollm-360m-reduced", "steps": 3,
        "n_arrays": len(list(leaves(init)))}


def test_launch_train_dry_run_names_roadmap_item_14(monkeypatch, capsys):
    """``--dry-run`` (ROADMAP item 14, ported) runs the production-mesh
    dry run of the full-size arch at train_4k on both meshes, as the
    reference's launcher does, and exits with its code.  The command the
    launcher would start runs here, in this process, with each
    combination's ``dryrun_one`` recorded (the dry runs themselves are
    held in ``test_torch_dryrun.py``)."""
    cmds, runs = [], []

    def call(cmd):
        cmds.append(cmd)
        return dryrun.main(cmd[3:])

    def one(arch, shape, multi_pod, **kw):
        runs.append((arch, shape, multi_pod))
        return {"arch": arch, "shape": shape}
    monkeypatch.setattr(subprocess, "call", call)
    monkeypatch.setattr(dryrun, "dryrun_one", one)
    assert tlaunch.main(["--arch", "smollm-360m-reduced", "--dry-run"]) == 0
    assert cmds == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", "smollm-360m", "--shape", "train_4k",
                     "--both-meshes"]]
    assert runs == [("smollm-360m", "train_4k", False),
                    ("smollm-360m", "train_4k", True)]
    assert "2 OK, 0 failed" in capsys.readouterr().out

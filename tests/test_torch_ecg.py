"""The port's ECG ResNeXt against the JAX package's, on the same weights.

JAX params are carried across with ``params_from_numpy`` (the two RNGs
differ), and one committed ``results/zoo_cache/*.npz`` member is loaded
with ``load_zoo_npz`` and fed to both packages.  Logits agree within the
one tolerance of ``repro_torch.testing``.
"""
import glob
import os

import numpy as np
import pytest
import torch

import jax

from repro.configs.ecg_zoo import zoo_specs as jzoo_specs
from repro.launch.ensemble_parallel import stack_members as jstack
from repro.models import ecg_resnext as jecg
from repro_torch.configs.ecg_zoo import EcgModelSpec, zoo_specs
from repro_torch.launch.ensemble_parallel import stack_members
from repro_torch.models import ecg_resnext as tecg
from repro_torch.models.convert import (load_zoo_npz, params_from_numpy,
                                        unflatten)
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SPECS = zoo_specs(reduced=True, input_len=250)


def _jax_params(i, spec):
    return jecg.init_ecg(jax.random.PRNGKey(i), spec)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def test_zoo_specs_match_reference():
    for reduced in (True, False):
        assert [tuple(vars(s).values()) for s in zoo_specs(reduced)] == \
            [tuple(vars(s).values()) for s in jzoo_specs(reduced)]


@pytest.mark.parametrize("i", range(4), ids=[s.name for s in SPECS[:4]])
def test_ecg_apply_matches_jax(i):
    spec = SPECS[i]
    jp = _jax_params(i, spec)
    x = np.random.default_rng(i).standard_normal(
        (3, spec.input_len, 1)).astype(np.float32)
    want = jecg.ecg_apply(jp, x, spec)
    got = tecg.ecg_apply(params_from_numpy(_np_tree(jp)),
                         torch.from_numpy(x), spec)
    assert tuple(got.shape) == (3, 2)
    assert_close(got, want, spec.name)


@pytest.mark.parametrize("width,blocks", [(8, 4), (16, 2)])
def test_ecg_apply_stacked_matches_jax(width, blocks):
    specs = [s for s in SPECS if s.width == width and s.blocks == blocks]
    assert len(specs) == 3                     # one per lead
    jps = [_jax_params(10 + j, s) for j, s in enumerate(specs)]
    x = np.random.default_rng(width).standard_normal(
        (3, 4, specs[0].input_len, 1)).astype(np.float32)
    want = jecg.ecg_apply_stacked(jstack(jps), x, specs[0])
    stacked = stack_members([params_from_numpy(_np_tree(p)) for p in jps])
    got = tecg.ecg_apply_stacked(stacked, torch.from_numpy(x), specs[0])
    assert tuple(got.shape) == (3, 4, 2)
    assert_close(got, want)
    # and each stacked member equals its own per-member pass
    for m in range(3):
        one = tecg.ecg_apply(params_from_numpy(_np_tree(jps[m])),
                             torch.from_numpy(x[m]), specs[m])
        assert_close(got[m], one, f"member {m}")


def test_stack_members_matches_jax():
    jps = [_jax_params(j, SPECS[0]) for j in range(3)]
    want = jax.tree.leaves(jstack(jps))
    got = list(tecg.leaves(stack_members(
        [params_from_numpy(_np_tree(p)) for p in jps])))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bitwise(g, np.asarray(w))


def test_committed_zoo_npz_feeds_both_packages():
    path = sorted(glob.glob(os.path.join(
        ROOT, "results", "zoo_cache", "*_lead1_w8_b4.npz")))[0]
    spec = EcgModelSpec(name="lead1_w8_b4", lead=0, width=8, blocks=4,
                        input_len=750, cardinality=8)
    params = load_zoo_npz(path)
    jp = jax.tree.map(lambda t: t.numpy(), params)
    x = np.random.default_rng(5).standard_normal((2, 750, 1)).astype(
        np.float32)
    want = jecg.ecg_apply(jp, x, spec)
    got = tecg.ecg_apply(params, torch.from_numpy(x), spec)
    assert_close(got, want)
    assert tecg.ecg_param_count(params) == jecg.ecg_param_count(jp)


def test_unflatten_builds_lists_from_digit_keys():
    tree = unflatten({"blocks/1/w": 1, "blocks/0/w": 0, "head/b": 2})
    assert tree == {"blocks": [{"w": 0}, {"w": 1}], "head": {"b": 2}}


@pytest.mark.parametrize("reduced", [True, False])
def test_init_shapes_macs_and_param_count_match_jax(reduced):
    for i, spec in enumerate(zoo_specs(reduced)[:10]):
        jp = _jax_params(i, spec)
        tp = tecg.init_ecg(spec, torch.Generator().manual_seed(i))
        assert [tuple(t.shape) for t in tecg.leaves(tp)] == \
            [tuple(a.shape) for a in jax.tree.leaves(jp)]
        assert tecg.ecg_param_count(tp) == jecg.ecg_param_count(jp)
        assert tecg.ecg_macs(spec) == jecg.ecg_macs(spec)


def test_init_is_seeded_truncated_normal():
    spec = SPECS[3]
    a = tecg.init_ecg(spec, torch.Generator().manual_seed(7))
    b = tecg.init_ecg(spec, torch.Generator().manual_seed(7))
    for ta, tb in zip(tecg.leaves(a), tecg.leaves(b)):
        assert torch.equal(ta, tb)
    w = a["blocks"][0]["reduce"]["w"]            # [1, W, inner]
    sigma = 1.0 / np.sqrt(w.shape[0])
    assert float(w.abs().max()) <= 2 * sigma
    stripe = a["blocks"][0]["stripe"]["w"]       # [7, cin_g, inner]
    assert float(stripe.abs().max()) <= 2 / np.sqrt(7)
    assert float(stripe.std()) > 0.5 / np.sqrt(7)


def test_group_norm_fallback_matches_jax():
    """C=6 with 4 requested groups falls back to 3; the stacked form
    takes per-member scale and bias."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 9, 6)).astype(np.float32)
    p = {"scale": rng.standard_normal((2, 6)).astype(np.float32),
         "bias": rng.standard_normal((2, 6)).astype(np.float32)}
    want = jax.vmap(jecg._group_norm)(p, x)
    got = tecg._group_norm(params_from_numpy(p), torch.from_numpy(x))
    assert_close(got, want)

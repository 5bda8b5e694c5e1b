"""The plain reference against the port's plain path (``impl="torch"``)
on the CPU, at a tiny zoo, and its TF32 rounding."""
import numpy as np
import pytest
import torch

from bench.harness import runner
from bench.harness.weights import make_params, side_data
from bench.reference import side as ref_side
from bench.reference.ensemble import eq5, member_probs
from bench.reference.resnext import round_tf32


def test_reference_matches_the_port_on_the_cpu(tiny_cell):
    from repro_torch.serving.pipeline import EnsembleService, ZooMember
    c = tiny_cell
    cpu = torch.device("cpu")
    members = c.members
    params = make_params(members, 2 ** 31 + 17, cpu)
    fit = side_data(c.config, 17)
    vit, labs = runner._side_models(c.config, 17, fit)
    svc = EnsembleService([ZooMember(s, p) for s, p
                           in zip(runner._specs(members), params)],
                          vitals_model=vit, labs_model=labs, impl="torch",
                          device="cpu")
    rng = np.random.default_rng(0)
    L = members[0]["input_len"]
    W = c.config["vitals_hz"] * c.config["window_seconds"]
    ecg = rng.standard_normal((5, 3, L), np.float32)
    vw = rng.standard_normal((5, 7, W), np.float32)
    lw = rng.standard_normal((5, 8), np.float32)
    got = svc.predict_batch([{"ecg": ecg[i], "vitals": vw[i], "labs": lw[i]}
                             for i in range(5)])
    rvit, rlabs = runner._ref_side_models(c.config, 17, fit)
    want = eq5(member_probs(members, params, torch.from_numpy(ecg)), vw, lw,
               rvit, rlabs)
    assert np.abs(np.array(got) - want).max() < 1e-6
    tf32 = eq5(member_probs(members, params, torch.from_numpy(ecg),
                            tf32=True), vw, lw, rvit, rlabs)
    assert np.abs(tf32 - want).max() > 1e-5


def test_side_model_copies_equal_the_programs(tiny_cell):
    from repro_torch.models.tabular import LogisticRegression, VitalsForest
    fit = side_data(tiny_cell.config, 3)
    a = VitalsForest(7, n_trees=4, seed=9).fit(fit["vitals"], fit["vitals_y"])
    b = ref_side.VitalsForest(7, 4, 9).fit(fit["vitals"], fit["vitals_y"])
    assert np.array_equal(a.predict_proba(fit["vitals"]),
                          b.predict_proba(fit["vitals"]))
    la = LogisticRegression(steps=40, seed=9).fit(fit["labs"], fit["labs_y"])
    lb = ref_side.LogisticRegression(40, 9).fit(fit["labs"], fit["labs_y"])
    assert np.array_equal(la.predict_proba(fit["labs"]),
                          lb.predict_proba(fit["labs"]))


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    (1.0 + 2 ** -11, 1.0),                 # half an ulp: ties to even
    (1.0 + 3 * 2 ** -11, 1.0 + 2 ** -9),   # three halves: rounds up
    (-(1.0 + 3 * 2 ** -11), -(1.0 + 2 ** -9)),
    (1.0 + 2 ** -10 + 2 ** -11, 1.0 + 2 ** -9),   # tie from odd: up
])
def test_tf32_rounding(x, want):
    assert round_tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_weights_are_one_buffer_from_the_seed(tiny_cell):
    cpu = torch.device("cpu")
    a = make_params(tiny_cell.members, 5, cpu)
    b = make_params(tiny_cell.members, 5, cpu)
    assert torch.equal(a[3]["blocks"][1]["stripe"]["w"],
                       b[3]["blocks"][1]["stripe"]["w"])
    base = a[0]["stem"]["w"].untyped_storage().data_ptr()
    assert a[-1]["head"]["b"].untyped_storage().data_ptr() == base
    assert not torch.equal(make_params(tiny_cell.members, 6, cpu)[0]
                           ["stem"]["w"], a[0]["stem"]["w"])
    gn = a[0]["stem_gn"]["scale"]
    assert 0.7 < float(gn.min()) and float(gn.max()) < 1.3

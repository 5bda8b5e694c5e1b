"""The check's control at a size a test run holds: the reference in TF32
in the program's place, judged by the run's own check, must come out not
correct, and by its widest gap."""
import torch

from bench.harness.runner import control_reading


def test_tf32_control_fails_the_limit(tiny_cell):
    r = control_reading(tiny_cell, 2 ** 31 + 3, 1.0, torch.device("cpu"))
    assert r["queries"] == tiny_cell.n_beds
    assert r["correct"] is False
    err = r["checks"]["max_abs_err"]
    assert err["value"] > err["limit"] == tiny_cell.config["score_abs_limit"]
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items()
               if k != "max_abs_err")

"""The runner a configuration file names (``bench/harness/cells.py``'s
runner contract): both configurations resolve to the zoo's runner, a
named module is the one run, a runner file beside the zoo's runs its
cells and leaves the zoo's alone, an unknown name stops before any CUDA
work, ``bench/run.py`` builds its result from the contract's fields
alone, and the tiny ``zoo60-steady`` cell prints what ``run.py``
printed before runners could be named (``bench/golden/``)."""
import importlib
import json
import re
import sys
import types

import pytest
import torch

from bench.conftest import tiny
from bench.harness import cells, runner
from bench.harness.cells import BENCH, ROOT, load_cell, load_json, load_runner

SPEC = load_json(ROOT / "BENCHMARK.json")
GOLDEN = load_json(BENCH / "golden" / "zoo60-steady-tiny.json")
ZOO_FIELDS = ("beds", "offered_per_s", "late_", "backlog", "shed", "members",
              "score_p95_ms")
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
DESCRIBED = ("load:", "latencies_ms", "check ")


@pytest.fixture
def run_py():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    return run


@pytest.fixture
def card(monkeypatch, run_py):
    """A card as ``run.py`` looks for one, its caches' variables restored
    afterwards, and the JAX guard blind to what other tests in this
    process loaded (``test_bench_imports.py`` tests the guard)."""
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    monkeypatch.setattr(run_py, "forbidden_modules", lambda: [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")


def _cell_file(tmp_path, **extra):
    """A ``BENCHMARK.json`` of one cell, ``stub-steady``, whose
    configuration is ``holmes-zoo60``'s with ``extra`` keys."""
    conf = dict(load_json(BENCH / "configs" / "holmes-zoo60.json"), **extra)
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    spec = dict(SPEC, configs=[{"name": "stub", "source": "-",
                                "file": str(tmp_path / "conf.json"),
                                "reduced": [], "why": "-"}],
                workloads=[{"name": "stub-steady", "config": "stub",
                            "traffic": "steady-64", "chips": 1, "why": "-"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json"


def _stub_out(trace):
    out = {"correct": True, "attempted": 4, "failed": 0,
           "metrics": {"setup_s": (3.5, "s"), "tokens_per_s": (9.0, "t/s")},
           "memory_peak_bytes": 123, "load": {"requests": 4},
           "checks": {"logit_gap": {"value": 0.5, "limit": 1.0}},
           "setup_s": 3.5}
    if trace:
        out.update(busy_s=0.25, window_s=2.0,
                   breakdown={"device_ops": [["k", 0.25]], "idle_gaps": []})
    return out


def _stub(monkeypatch, name="stub_runner"):
    mod = types.ModuleType(f"bench.harness.{name}")
    mod.run = lambda cell, seed, seconds, trace, device, t_start, beds=None: \
        _stub_out(trace)
    mod.describe = lambda out: [f"stub: {out['load']['requests']} requests"]
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


ZOO = ["zoo60-steady", "zoo12-steady"]
LM_STUB = '''"""A runner beside the zoo's, as a later cell's would be."""


def run(cell, seed, seconds, trace, device, t_start, beds=None):
    if beds is not None:
        raise ValueError("no census in this traffic")
    out = {"correct": True, "attempted": 2, "failed": 0,
           "metrics": {"setup_s": (1.5, "s")}, "memory_peak_bytes": 7,
           "load": {"requests": 2},
           "checks": {"gap": {"value": 0.1, "limit": 1.0}}, "setup_s": 1.5}
    if trace:
        out.update(busy_s=0.5, window_s=1.0,
                   breakdown={"device_ops": [], "idle_gaps": []})
    return out


def describe(out):
    return [f"lm_stub: {out['load']['requests']} requests"]
'''


@pytest.fixture
def second_runner(tmp_path, monkeypatch):
    """``lm_stub.py``, a runner file in a directory of ``bench.harness``'s
    package path beside ``bench/harness/``, removed afterwards."""
    import bench.harness
    extra = tmp_path / "harness_extra"
    extra.mkdir()
    (extra / "lm_stub.py").write_text(LM_STUB)
    monkeypatch.setattr(bench.harness, "__path__",
                        [*bench.harness.__path__, str(extra)])
    importlib.invalidate_caches()
    yield "lm_stub"
    sys.modules.pop("bench.harness.lm_stub", None)


@pytest.mark.parametrize("second", [False, True], ids=["alone", "beside"])
@pytest.mark.parametrize("workload", ZOO)
def test_configuration_without_the_key_runs_the_zoo_runner(request, workload,
                                                           second):
    if second:
        request.getfixturevalue("second_runner")
    cell = load_cell(workload)
    assert "runner" not in cell.config
    assert cell.runner == "bench.harness.runner"
    assert load_runner(cell) is runner


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_a_runner_module(workload):
    cell = load_cell(workload)
    mod = load_runner(cell)
    assert mod.__name__ == cell.runner
    assert mod.__name__.rsplit(".", 1)[1] in cells.runners()


def test_configuration_naming_a_module_runs_it(tmp_path, monkeypatch):
    stub = _stub(monkeypatch)
    cell = load_cell("stub-steady", bench_file=_cell_file(
        tmp_path, runner="stub_runner"))
    assert cell.runner == "bench.harness.stub_runner"
    assert load_runner(cell) is stub


@pytest.mark.parametrize("trace", [0, 1])
def test_a_runner_file_beside_the_zoos_runs_its_cells(
        tmp_path, monkeypatch, capsys, run_py, card, second_runner, trace):
    assert {"runner", second_runner} <= set(cells.runners())
    bench_file = _cell_file(tmp_path, runner=second_runner)
    monkeypatch.setattr(cells, "load_cell",
                        lambda w: load_cell(w, bench_file=bench_file))
    assert run_py.main(["--workload", "stub-steady", "--seed", "1",
                        "--seconds", "1", "--trace", str(trace)]) == 0
    std = capsys.readouterr()
    result = json.loads(std.out.strip().splitlines()[-1])
    assert result["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"}}
    assert result["load"] == {"requests": 2}
    assert ("busy_s" in result["device"]) is bool(trace)
    assert "lm_stub: 2 requests" in std.err.splitlines()
    assert std.err.splitlines()[-1] == "check gap 0.1 limit 1.0"


@pytest.mark.parametrize("second", [False, True], ids=["alone", "beside"])
@pytest.mark.parametrize("name", ["no_such_runner", "cells", "runner.run",
                                  "../run"])
def test_unknown_runner_stops_before_cuda(tmp_path, monkeypatch, request,
                                          run_py, name, second):
    if second:
        request.getfixturevalue("second_runner")
    bench_file = _cell_file(tmp_path, runner=name)
    monkeypatch.setattr(cells, "load_cell",
                        lambda w: load_cell(w, bench_file=bench_file))

    def no_cuda():
        raise AssertionError("CUDA looked for before the runner resolved")
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    with pytest.raises(SystemExit) as e:
        run_py.main(["--workload", "stub-steady", "--seed", "1",
                     "--seconds", "1"])
    assert repr(name) in str(e.value)
    listed = cells.runners()
    assert "runner" in listed and ("lm_stub" in listed) is second
    assert str(listed) in str(e.value)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_holds_the_contract_and_nothing_of_the_zoo(
        tmp_path, monkeypatch, capsys, run_py, card, trace):
    _stub(monkeypatch)
    bench_file = _cell_file(tmp_path, runner="stub_runner")
    monkeypatch.setattr(cells, "load_cell",
                        lambda w: load_cell(w, bench_file=bench_file))
    assert run_py.main(["--workload", "stub-steady", "--seed", "1",
                        "--seconds", "1", "--trace", str(trace)]) == 0
    std = capsys.readouterr()
    line = std.out.strip().splitlines()[-1]
    result = json.loads(line)
    assert result == json.loads(json.dumps(run_py.result_of(
        _stub_out(trace), "NVIDIA H100 80GB HBM3", 1, bool(trace))))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device"] + ["breakdown"] * trace \
        + ["load", "checks"]
    assert result["metrics"]["tokens_per_s"] == {"value": 9.0, "unit": "t/s"}
    assert ("busy_s" in result["device"]) is bool(trace)
    assert result["load"] == {"requests": 4}
    assert not [f for f in ZOO_FIELDS if f in line]
    assert "stub: 4 requests" in std.err.splitlines()
    assert std.err.splitlines()[-1] == "check logit_gap 0.5 limit 1.0"


def test_run_py_names_no_field_of_the_zoo():
    src = (BENCH / "run.py").read_text()
    for beds in ('"--beds"', "``--beds``", "beds=args.beds"):
        src = src.replace(beds, "")
    assert [f for f in ZOO_FIELDS if f in src] == []


def _shape(stdout, stderr):
    """The result's keys, metric names and the lines ``run.py`` prints
    from the run, every number in them masked."""
    result = json.loads(stdout.strip().splitlines()[-1])
    return {"keys": list(result), "device": list(result["device"]),
            "load": list(result["load"]), "metrics": sorted(result["metrics"]),
            "checks": list(result["checks"]),
            "stderr": [NUM.sub("#", ln) for ln in stderr.splitlines()
                       if ln.startswith(DESCRIBED)]}


@pytest.mark.parametrize("trace", [0, 1], ids=["plain", "traced"])
def test_tiny_zoo60_prints_what_it_printed(monkeypatch, capsys, run_py, card,
                                           trace):
    run = runner.run
    monkeypatch.setattr(cells, "load_cell", lambda w: tiny(load_cell(w)))
    monkeypatch.setattr(runner, "run", lambda c, s, sec, tr, dev, t0,
                        beds=None: run(c, s, sec, tr, torch.device("cpu"),
                                       t0, beds=beds))
    assert run_py.main(["--workload", "zoo60-steady", "--seed",
                        str(2 ** 31 + 21), "--seconds", "1", "--trace",
                        str(trace)]) == 0
    std = capsys.readouterr()
    assert json.loads(std.out.strip().splitlines()[-1])["correct"]
    assert _shape(std.out, std.err) == \
        GOLDEN["traced" if trace else "plain"]

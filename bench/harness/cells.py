"""A cell of ``BENCHMARK.json``: its configuration and traffic files,
found by name, the runner its configuration names, and its metrics'
readers.

**The runner contract.**  A configuration file may name the module that
runs its cells in the key ``"runner"``: a module under ``bench/harness/``,
by its name there (``"runner"`` is ``bench/harness/runner.py``, the ICU
zoo's, and is taken where the key is absent).  ``bench/run.py`` imports
it before any CUDA work, calls its ``run`` and prints the result line
from the fields below alone.  A runner module has:

``run(cell, seed, seconds, trace, device, t_start, beds=None) -> dict``
    One run of ``cell`` on ``device``: set-up, the measured window of
    ``seconds``, then, with the program's state freed, the check against
    the plain reference.  ``t_start`` is the process's start on
    ``time.monotonic``.  ``beds`` overrides the traffic's census; a
    runner whose traffic has no census raises ``ValueError`` when given
    one.  The dict holds:

    - ``correct``, ``attempted``, ``failed``: as the result line has
      them;
    - ``metrics``: ``{name: (value, unit)}``, the cell's end-to-end
      metrics, or with ``trace`` its per-layer ones, each from its
      reader (``reader``) over the run's observations; a metric whose
      reader returns ``None`` is left out;
    - ``memory_peak_bytes``: the card's peak, read before the reference
      runs;
    - ``checks``: ``{name: {"value": v, "limit": l}}``, every number the
      check compared; ``correct`` is every value within its limit;
    - ``load``: the runner's own readings of what it offered and what
      the check did, printed whole as the result's ``load``;
    - ``setup_s``: process start to window start, in seconds;
    - with ``trace``, where the run read a device trace: ``busy_s``,
      ``window_s`` and ``breakdown`` (``trace.ProfiledSlice.fields``).

``describe(out) -> list[str]``
    The lines of standard error that say what the run offered and saw,
    from ``run``'s dict; ``run.py`` prints them before the checks.

The end-to-end readers (``bench/metrics/``) read the same observations
from every runner:

- ``latency_s``: one entry a request due in the window, in due order:
  the seconds from its due instant to its answer's retirement, both on
  the harness's clock; a request that failed, or whose answer was not
  retired within the traffic's drain limit, counts at that limit;
- ``scored``: the requests due in the window whose answer is finite and
  retired within the drain limit;
- ``seconds``: the window's length; ``setup_s``: as above.

So a runner that fills them reports ``score_p50_ms``, ``scores_per_s``
and ``setup_s`` under their bounds with the readers as they stand.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / "bench"
HARNESS = "bench.harness"
DEFAULT_RUNNER = "runner"
_MEMBER = re.compile(r"lead(\d+)_w(\d+)_b(\d+)$")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int = 1

    @property
    def runner(self) -> str:
        """The module that runs this cell: ``bench.harness.<"runner">``
        of the configuration file, ``bench.harness.runner`` without it."""
        return f"{HARNESS}.{self.config.get('runner', DEFAULT_RUNNER)}"

    @property
    def members(self) -> List[Dict]:
        return members_of(self.config)

    @property
    def n_beds(self) -> int:
        return int(self.traffic["beds"])


def members_of(config: Dict) -> List[Dict]:
    """The configuration's zoo members, in its order, as plain dicts
    (``lead`` 0-based, ``width``, ``blocks``, ``input_len``,
    ``cardinality`` = min(cap, width), ``kernel_size``)."""
    L = int(round(config["ecg_hz"] * config["window_seconds"]))
    out = []
    for name in config["members"]:
        m = _MEMBER.match(name)
        if m is None:
            raise ValueError(f"member {name!r} is not lead<l>_w<w>_b<b>")
        lead, width, blocks = map(int, m.groups())
        out.append({"name": name, "lead": lead - 1, "width": width,
                    "blocks": blocks, "input_len": L,
                    "cardinality": min(config["cardinality_cap"], width),
                    "kernel_size": config["kernel_size"]})
    return out


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    spec = load_json(bench_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_file.name}; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    layer = [m for m in spec["per_layer"]
             if "workloads" not in m or workload in m["workloads"]]
    return Cell(name=workload, config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer, chips=int(w["chips"]))


def runners() -> List[str]:
    """The runner modules of ``bench.harness``, wherever its package path
    finds them: those whose source defines ``run`` and ``describe`` at
    its top level."""
    out = set()
    for directory in importlib.import_module(HARNESS).__path__:
        for path in Path(directory).glob("*.py"):
            tree = ast.parse(path.read_text(), str(path))
            defs = {n.name for n in tree.body
                    if isinstance(n, ast.FunctionDef)}
            if {"run", "describe"} <= defs:
                out.add(path.stem)
    return sorted(out)


def load_runner(cell: Cell) -> ModuleType:
    """The module ``cell.runner`` names, imported.  A name that is no
    runner module exits, naming the runner modules there are."""
    name = cell.runner[len(HARNESS) + 1:]
    mod = None
    if name.isidentifier():
        try:
            mod = importlib.import_module(cell.runner)
        except ModuleNotFoundError as e:
            if e.name != cell.runner:
                raise
    if not all(callable(getattr(mod, f, None)) for f in ("run", "describe")):
        raise SystemExit(f"{cell.name}: the configuration's runner {name!r} "
                         f"is no runner module of bench/harness/; there are "
                         f"{runners()}")
    return mod


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``bench/metrics/<metric>.py``'s ``read(obs)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""A cell of ``BENCHMARK.json``: its configuration and traffic files,
found by name, and its per-layer metrics' readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / "bench"
_MEMBER = re.compile(r"lead(\d+)_w(\d+)_b(\d+)$")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

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
                end_to_end=e2e, per_layer=layer)


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``bench/metrics/<metric>.py``'s ``read(obs)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

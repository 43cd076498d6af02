"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic; the configuration is
its own file (``file`` in BENCHMARK.json), the traffic
``benchmark/traffic/<traffic>.json``, each metric ``benchmark/metrics/readers/``
(see :mod:`benchmark.metrics`)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as it is run
    traffic: dict         # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` of BENCHMARK.json is reported in ``cell``."""
    cells = metric.get("workloads")
    return cells is None or cell in cells


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config=_read(os.path.join(root, cfg["file"])),
        traffic=_read(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])

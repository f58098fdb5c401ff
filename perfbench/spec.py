"""What BENCHMARK.json names, found by name: a cell's configuration file,
its traffic file <benchmark folder>/traffic/<traffic>.json, and the reader
of each per-layer metric, <benchmark folder>/metrics/<metric>.py. Adding a
cell, a configuration, a traffic mix or a metric adds files and entries; no
file here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    home: Path  # the benchmark's folder (the first of `paths`)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    benchmark = Path(benchmark)
    root = benchmark.parent
    spec = load_json(benchmark)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {benchmark}: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    home = root / spec["paths"][0]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / cfg["file"]),
        traffic=load_json(home / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)],
        home=home,
    )


def load_module(path: Path, name: str):
    """The Python file at `path`, loaded as a module named `name`."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, metric: str):
    """The module metrics/<metric>.py of the cell's benchmark folder: LAYER,
    MOVES and read(run) -> float or None (None: nothing to read in this
    run, and the metric is left out of the result)."""
    return load_module(cell.home / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}")

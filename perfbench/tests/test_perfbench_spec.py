"""The harness finds every cell's files by name, and a cell added as data
alone loads with no file of the benchmark changed."""

import json
import shutil

import pytest

from perfbench import spec

SPEC = spec.load_json(spec.BENCHMARK)
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = spec.cell(name)
    assert c.config["name"] == name.split(".")[0]
    assert c.traffic["chains"] >= 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        mod = spec.reader(c, m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert any(e["name"] == m["moves"] for e in c.end_to_end)


def test_data_only_cell_loads(tmp_path):
    """A later cell brings a traffic file and a workload entry only."""
    shutil.copytree(spec.ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    traffic = dict(spec.load_json(tmp_path / "perfbench/traffic/cb-b16.json"), chains=64)
    (tmp_path / "perfbench/traffic/cb-b64.json").write_text(json.dumps(traffic))
    bench = json.loads(spec.BENCHMARK.read_text())
    bench["workloads"].append({"name": "ka3d-n10k.cb-b64", "config": "ka3d-n10k", "traffic": "cb-b64", "chips": 1,
                               "why": "64 chains"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("ka3d-n10k.cb-b64", tmp_path / "BENCHMARK.json")
    assert c.traffic["chains"] == 64 and c.config["system"]["n"] == 10000
    assert {m["name"] for m in c.per_layer} == {m["name"] for m in SPEC["per_layer"] if "workloads" not in m}
    for p, data in before.items():
        assert (tmp_path / p).read_bytes() == data

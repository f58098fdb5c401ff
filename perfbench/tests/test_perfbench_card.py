"""On the card: one short run of every cell through the benchmark's command,
its last line in the contract's form and correct; and the control of the
checkerboard cells, the program's own float32 ledger, failing the drift.
Skips without a card.

    python -m pytest perfbench/tests/test_perfbench_card.py -q -m cuda -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec

CELLS = [w["name"] for w in spec.load_json(spec.BENCHMARK)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed", str(2**31 + 11),
         "--seconds", "10", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    c = spec.cell(name)
    want = c.per_layer if trace else c.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        share = result["metrics"].get("cb_kernel_roofline_share")
        assert share is None or 0 < share["value"] < 100


@pytest.mark.cuda
def test_float32_ledger_control_fails_the_drift():
    """cb-b16 at its own size (16 chains of N = 10,000), one seed, the
    window of a run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seconds = spec.load_json(spec.BENCHMARK)["run_seconds"]
    out = subprocess.run(
        [sys.executable, "perfbench/control.py", "--workload", "ka3d-n10k.cb-b16", "--seconds", str(seconds),
         "--mode", "float32-ledger", "--seeds", str(2**31 + 12)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ledger_drift" in reading["fails"], reading["checks"]

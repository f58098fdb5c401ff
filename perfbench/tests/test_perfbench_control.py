"""The bfloat16 control of the check reads as not correct: the plain
reference sampler put in the program's place with its energy changes in
bfloat16 (reference/sampler.py), on each configuration's system at a size a
CPU test run holds, drifts past every cell's limit by far, and by a thousand
times the same sampler at the configuration's float32 (float32 distances
and energies, float64 ledger). It is seq-b64's control; the checkerboard
cells' control, the program's own float32 ledger, runs on the card
(test_perfbench_card.py)."""

import pytest
import torch

from perfbench import cell as CELL
from perfbench import generate, spec
from perfbench.reference.sampler import metropolis

SPEC = spec.load_json(spec.BENCHMARK)


@pytest.mark.parametrize("name,n", [("ka3d-n10k.cb-b256", 1300), ("jbb2d-n1000.seq-b64", 1000)])
def test_control_fails_the_limit(name, n):
    c = spec.cell(name)
    sysc = dict(c.config["system"], n=n)
    B, cpu = 4, torch.device("cpu")
    g = generate.start(sysc, c.config["start"], B, 11, cpu)
    pos = g["position"].float()
    box = torch.full((B, sysc["dim"]), g["box_side"])
    temp = torch.full((B,), float(sysc["temperature"]))
    sigma = float(c.traffic["pool"][0]["args"]["sigma"])
    limits = [float(spec.cell(w["name"]).traffic["limits"]["ledger_drift"])
              for w in SPEC["workloads"] if w["config"] == c.config["name"]]
    drifts = {}
    for compute in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(3)
        x, l0, l1, att, _ = metropolis(pos, g["species"], box, temp, c.config["potential"], sigma, 400, gen, compute)
        snaps = [dict(position=pos, species=g["species"], ledger=l0, attempted=torch.zeros_like(att)[:, None]),
                 dict(position=x, species=g["species"], ledger=l1, attempted=att[:, None])]
        drifts[compute] = CELL.ledger_drift(c.config["potential"], snaps, box)
    assert drifts[torch.bfloat16] > 10 * max(limits)
    assert drifts[torch.float32] < drifts[torch.bfloat16] / 1000

"""The LJ-mixture swap cell (ljmix-n4096.cb-swap-b8) on the CPU:

- its plain reference sampler (reference/cell_swap_sampler.py) keeps its
  float64 ledger equal to the recomputed total energy while species change;
  its in-cell swaps sample the Boltzmann distribution over the species
  arrangements of a few fixed particles spread over several cells; where
  the grid is one cell (a box under two cutoffs wide) its swaps accept as
  reference/swap_sampler.py's global DoubleUniform swaps do, and its
  displacements as reference/sampler.py's;
- the cell at a small size (a 4^3 grid at a low density), driven through
  the harness as on the chip, reads correct, and each fault of the timed
  path (test_perfbench_faults.py's) turns it false by the number that
  catches it; of the move-choice faults planted in the checkerboard's
  schedule (cb_control.py), swaps never scheduled fail it and swaps at half
  their slots read `move_share_z` well above the sound run's.
"""

import copy
import itertools
import math
import time

import pytest
import torch

from perfbench import cb_control, generate, spec
from perfbench import cell as CELL
from perfbench.reference import cell_swap_sampler, sampler, swap_sampler
from perfbench.reference.energy import total_energy
from perfbench.tests.test_perfbench_faults import FAULTS, break_program

NAME = "ljmix-n4096.cb-swap-b8"
CFG = spec.cell(NAME).config
POT = CFG["potential"]
SWAP = [{"move": "discrete_swap", "args": {"s1": 0, "s2": 1, "probability": 1.0}}]
CPU = torch.device("cpu")


def start(n, rho, chains, seed=7):
    g = generate.start(dict(CFG["system"], n=n, density=rho), CFG["start"], chains, seed, CPU)
    box = torch.full((chains, 3), g["box_side"], dtype=torch.float64)
    temp = torch.full((chains,), float(CFG["system"]["temperature"]), dtype=torch.float64)
    return g["position"], g["species"], box, temp


def test_cells_per_side():
    assert [cell_swap_sampler.cells_per_side(L, 4.0) for L in (7.9, 8.0, 11.9, 12.0, 16.0, 17.2)] == [1, 2, 2, 2, 4, 4]


def test_ledger_and_composition():
    pos, sp, box, temp = start(1000, 0.22, 4)  # a 4^3 grid
    pool = spec.cell(NAME).traffic["pool"]
    x, s, l0, l1, att, acc = cell_swap_sampler.metropolis(pos, sp, box, temp, POT, pool, 600,
                                                          torch.Generator().manual_seed(1))
    gap = (l1 - l0) - (total_energy(x, s, box, POT) - total_energy(pos, sp, box, POT))
    assert float(gap.abs().max()) < 1e-9
    assert bool((s != sp).any()) and bool((acc > 0).all())
    for k in range(2):
        assert torch.equal((s == k).sum(dim=1), (sp == k).sum(dim=1))
    assert torch.equal(att.sum(dim=1), torch.full((4,), 600))


def boltzmann_gap(temperature, weights_at=0.5, chains=4000, steps=400):
    """Largest gap between the share of chains in each species arrangement
    of five fixed particles (spread over a 2^3 grid of 4.25-wide cells)
    after `steps` in-cell swaps at `temperature` and the Boltzmann weight
    at `weights_at`, and the sampling error's three standard deviations."""
    n = 5
    x0 = torch.tensor([[3.2, 3.3, 3.9], [4.4, 3.6, 4.1], [3.5, 4.6, 4.4], [4.6, 4.7, 3.7], [5.6, 4.1, 4.6]],
                      dtype=torch.float64)[None]
    box = torch.full((chains, 3), 8.5, dtype=torch.float64)
    base = [0, 0, 1, 1, 1]
    arrangements = sorted(set(itertools.permutations(base)))
    u = total_energy(x0.expand(len(arrangements), n, 3), torch.tensor(arrangements), box[:len(arrangements)], POT)
    p = torch.softmax(-u / weights_at, 0)
    _, s, *_ = cell_swap_sampler.metropolis(
        x0.expand(chains, n, 3).clone(), torch.tensor(base).expand(chains, n).clone(), box,
        torch.full((chains,), temperature, dtype=torch.float64), POT, SWAP, steps, torch.Generator().manual_seed(1))
    seen = torch.tensor([arrangements.index(tuple(r)) for r in s.tolist()])
    h = torch.bincount(seen, minlength=len(arrangements)).double() / chains
    return float((h - p).abs().max()), 3 * math.sqrt(float(p.max()) / chains)


def test_in_cell_swaps_sample_boltzmann():
    assert cell_swap_sampler.cells_per_side(8.5, 4.0) == 2
    gap, tol = boltzmann_gap(0.5)
    assert gap < tol


def test_in_cell_swaps_at_another_temperature_do_not():
    """The control of the test above: the weights of 0.5 against a run at
    1.5 (the arrangements' energies span 0.7)."""
    gap, tol = boltzmann_gap(1.5)
    assert gap > 2 * tol


def test_one_cell_swaps_accept_as_the_global_swaps():
    """N 100 at rho 0.8: a box of 5.0 < 2 cutoffs, so the grid is one cell
    and the in-cell proposal is the global DoubleUniform one; 32 chains of
    600 swaps each side, the acceptances within 0.02 (about four standard
    deviations of their difference)."""
    pos, sp, box, temp = start(100, 0.8, 32)
    assert cell_swap_sampler.cells_per_side(float(box[0, 0]), 4.0) == 1
    *_, a1, c1 = cell_swap_sampler.metropolis(pos, sp, box, temp, POT, SWAP, 600, torch.Generator().manual_seed(2))
    *_, a2, c2 = swap_sampler.metropolis(pos, sp, box, temp, POT, SWAP, 600, torch.Generator().manual_seed(3))
    r1, r2 = float(c1.sum() / a1.sum()), float(c2.sum() / a2.sum())
    assert 0.05 < r1 < 0.95 and abs(r1 - r2) < 0.02


def test_displacements_accept_as_the_plain_sampler():
    pos, sp, box, temp = start(100, 0.8, 8)
    disp = [{"move": "displacement", "args": {"sigma": 0.05}}]
    *_, a1, c1 = cell_swap_sampler.metropolis(pos, sp, box, temp, POT, disp, 2000, torch.Generator().manual_seed(2))
    *_, a2, c2 = sampler.metropolis(pos, sp, box, temp, POT, 0.05, 2000, torch.Generator().manual_seed(3),
                                    compute=torch.float64)
    assert abs(float(c1.sum() / a1.sum()) - float(c2.sum() / a2.sum())) < 0.02


def small() -> spec.Cell:
    """The cell at a small size: N 1,000 at rho 0.22 (a box of 16.6, a 4^3
    grid of 4.15-wide cells, ~16 particles a cell, so that no active cell is
    empty), 16 chains, a cap of 48."""
    c = spec.cell(NAME)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["system"].update(n=1000, density=0.22)
    c.config["sampler"]["list_parameters"].update(cap=48, inner=4, rebin_every=2)
    c.traffic.update(chains=16, burn_in_steps=2, probe_steps=2, reference_chains=16, output_interval=3,
                     reference_steps=3000)
    return c


def run_small() -> dict:
    return CELL.run_cell(small(), 12345, 2.0, False, CPU, time.perf_counter())


@pytest.fixture(scope="module")
def sound():
    return run_small()


def test_sound_run_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["checks"]["species_changed"][0] == 0 and sound["checks"]["counter_mismatch"][0] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(sound, monkeypatch, fault):
    break_program(monkeypatch, fault)
    out = run_small()
    assert out["correct"] is False
    checks = out["checks"]
    B = small().traffic["chains"]
    if fault == "unchanged":
        assert checks["counter_mismatch"][0] == B
    elif fault == "half_batch":
        assert checks["counter_mismatch"][0] >= B - B // 2
    elif fault == "frozen":
        assert checks["frozen_excess"][0] > checks["frozen_excess"][1]
    elif fault in ("reject_all", "sigma_2x"):
        # the sound gap at this size is the in-cell rejection of the ~3% of
        # proposals that leave a 4.15-wide cell; in this dilute gas a
        # proposal twice as wide lowers the acceptance by as much again
        gap, limit = checks["acceptance_gap"]
        assert gap > limit and gap > (3 if fault == "reject_all" else 2) * sound["checks"]["acceptance_gap"][0]
    else:
        drift, limit = checks["ledger_drift"]
        assert drift > limit and drift > 100 * sound["checks"]["ledger_drift"][0]


@pytest.mark.parametrize("fault,every", [("swaps_never", 1), ("swaps_half", 2)])
def test_schedule_fault_separates(sound, monkeypatch, fault, every):
    """Swaps never scheduled fail by the swaps' gap, which reads 1; swaps at
    half their slots read `move_share_z` above 5 times the sound run's. The
    schedule's own rounding (6 of 64 slots for a share of 0.1) and the
    fault's both grow with the square root of the window's moves, so the
    full cell's limit, set between the two on the card, does not apply at
    this size (PERF.md)."""
    from particlesmc_tpu_torch.moves import checkerboard

    monkeypatch.setattr(checkerboard, "_slot_schedule", checkerboard._slot_schedule)
    cb_control.skew_schedule(every)
    out = run_small()
    z = out["checks"]["move_share_z"][0]
    assert z > 5 * sound["checks"]["move_share_z"][0]
    if fault == "swaps_never":
        assert out["correct"] is False
        assert out["checks"]["species_acceptance_gap"][0] == 1.0

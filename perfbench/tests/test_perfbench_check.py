"""The check's numbers per move of the pool, and the plain reference sampler
of pools with species swaps (reference/swap_sampler.py), on the CPU at
small sizes:

- on a pool of one move the per-move numbers are the pooled ones of a
  check that summed the counters over the moves, and with swaps the
  displacements and the swaps each have their own gap; a move never
  attempted fails, and each move's share of the attempts is held to the
  pool's probability;
- the swap sampler keeps its float64 ledger equal to the recomputed total
  energy while species change, and composition fixed;
- its displacements accept as reference/sampler.py's do;
- its swaps sample the Boltzmann distribution over the species
  arrangements of a few fixed particles, and do not once the Hastings term
  of EnergyBias is dropped.
"""

import itertools
import math
import types

import pytest
import torch

from perfbench import cell as CELL
from perfbench import generate, spec
from perfbench.reference import sampler, swap_sampler
from perfbench.reference.energy import total_energy

CFG = spec.cell("jbb2d-n1000.seq-swap-b28").config
POOL = spec.cell("jbb2d-n1000.seq-swap-b28").traffic["pool"]
T = float(CFG["system"]["temperature"])


def pooled_frozen_excess(first, last, n):
    """The frozen excess over counters summed over the pool's moves."""
    att = (last["attempted"] - first["attempted"]).sum(dim=-1).double()
    acc = (last["accepted"] - first["accepted"]).sum(dim=-1).double()
    expected = torch.exp(-acc / n)
    same = (first["position"] == last["position"]).all(dim=-1).double().mean(dim=-1)
    return float((same - torch.where(att > 0, expected, torch.ones_like(expected))).max())


def test_one_move_pool_reads_the_pooled_numbers(monkeypatch):
    k, n, d = 6, 50, 2
    g = torch.Generator().manual_seed(0)
    p0 = torch.rand((k, n, d), generator=g)
    p1 = torch.where(torch.rand((k, n, 1), generator=g) < 0.3, p0, p0 + 0.01)
    sp = torch.randint(3, (k, n), generator=g)
    att0, att1 = torch.randint(100, (k, 1), generator=g), torch.randint(1000, 2000, (k, 1), generator=g)
    acc0 = torch.randint(50, (k, 1), generator=g)
    acc1 = acc0 + torch.randint(300, 600, (k, 1), generator=g)
    first = dict(position=p0, species=sp, ledger=torch.zeros(k, dtype=torch.float64), attempted=att0, accepted=acc0)
    last = dict(position=p1, species=sp, ledger=torch.ones(k, dtype=torch.float64), attempted=att1, accepted=acc1)
    trf = {"pool": [{"move": "displacement", "args": {"sigma": 0.1}}], "reference_sampler": "sampler",
           "reference_steps": 10}

    assert CELL.frozen_excess(first, last, n, CELL.displacements(trf)) == pooled_frozen_excess(first, last, n)

    ref_att, ref_acc = 8000, 2345
    stub = types.SimpleNamespace(acceptance=lambda *a: (ref_att, ref_acc))
    monkeypatch.setattr(CELL, "reference_sampler", lambda name: stub)
    assert CELL.acceptance_span(trf, [first, last]) == (first, last, last, 10)
    gaps, prog, ref = CELL.acceptance_gap(CFG, trf, first, last, last, 10, torch.ones((k, d)), 1)
    moves = (last["attempted"] - first["attempted"]).sum()
    pooled = float((last["accepted"] - first["accepted"]).sum()) / max(1.0, float(moves))
    assert prog == [pooled] and ref == [ref_acc / ref_att]
    assert CELL.largest(gaps, CELL.displacements(trf)) == abs(pooled - ref_acc / ref_att)


def test_each_kind_of_move_has_its_own_gap(monkeypatch):
    """A pool with swaps reports the displacements' largest gap as
    acceptance_gap and the swaps' as species_acceptance_gap; a move that the
    program never attempted reads 1, so a program that stops drawing it
    fails."""
    k, n = 2, 10
    pos, sp = torch.rand((k, n, 2)), torch.zeros((k, n), dtype=torch.int64)
    zero = torch.zeros((k, 3), dtype=torch.int64)
    first = dict(position=pos, species=sp, ledger=torch.zeros(k, dtype=torch.float64), attempted=zero, accepted=zero)
    stub = types.SimpleNamespace(acceptance=lambda *a: ([1000, 100, 100], [400, 30, 10]))
    monkeypatch.setattr(CELL, "reference_sampler", lambda name: stub)
    monkeypatch.setattr(CELL, "ledger_drift", lambda *a: 0.0)
    trf = {"pool": POOL, "reference_sampler": "stub", "reference_steps": 10,
           "limits": {"ledger_drift": 1, "acceptance_gap": 1, "frozen_excess": 1, "species_acceptance_gap": 1,
                      "move_share_z": 1}}
    gaps = {}
    for swap2 in (20, 0):
        last = dict(position=pos + 0.01, species=sp, ledger=torch.zeros(k, dtype=torch.float64),
                    attempted=torch.tensor([[100, 10, swap2]] * k), accepted=torch.tensor([[50, 2, swap2 // 10]] * k))
        gaps[swap2] = CELL.judge(CFG, trf, [first, last], torch.ones((k, 2)), 1)
    assert gaps[20]["acceptance_gap"][0] == pytest.approx(0.1)
    assert gaps[20]["species_acceptance_gap"][0] == pytest.approx(0.1)
    assert gaps[0]["acceptance_gap"][0] == pytest.approx(0.1)
    assert gaps[0]["species_acceptance_gap"][0] == 1.0


@pytest.mark.parametrize("counts,low", [
    ([8000, 1000, 1000], True),  # the pool's shares
    ([8090, 960, 950], True),  # within the binomial spread (z at most 2.3)
    ([10000, 0, 0], False),  # swaps never drawn
    ([9000, 500, 500], False),  # swaps at half their share
    ([8000, 1500, 500], False),  # one swap drawn for the other
])
def test_move_share_is_held_to_the_pool(counts, low):
    k = 4
    zero = torch.zeros((k, 3), dtype=torch.int64)
    last = torch.tensor([counts] * k) // k
    z = CELL.share_z({"pool": POOL}, {"attempted": zero}, {"attempted": last})
    assert (z < 3) if low else (z > 10)


def test_one_move_pool_has_no_share_to_hold():
    one = {"pool": [{"move": "displacement", "args": {"sigma": 0.1}}]}
    zero = torch.zeros((3, 1), dtype=torch.int64)
    assert CELL.share_z(one, {"attempted": zero}, {"attempted": zero + 500}) == 0.0


def test_acceptance_span_follows_the_snapshots():
    """From the window's start where a snapshot past the first lies within
    reference_steps moves (the swap cell: snapshots every 2 sweeps of 1,000
    steps), else the whole window against the end state (the checkerboard
    and seq-b64 cells: hundreds of thousands of moves between snapshots);
    a snapshot with no moves since the start is no stretch."""
    snaps = [{"attempted": torch.full((2, 3), a)} for a in (0, 0, 700, 1400, 2100)]
    trf = {"reference_steps": 6300}
    assert CELL.acceptance_span(trf, snaps) == (snaps[0], snaps[4], snaps[0], 6300)
    trf = {"reference_steps": 4500}
    assert CELL.acceptance_span(trf, snaps) == (snaps[0], snaps[3], snaps[0], 4200)
    trf = {"reference_steps": 2000}
    assert CELL.acceptance_span(trf, snaps) == (snaps[0], snaps[4], snaps[4], 2000)


def test_displacement_share_leaves_swaps_out():
    """Accepted swaps move no particle: the frozen excess expects the
    unmoved share from the displacements' counters alone."""
    k, n = 2, 40
    pos = torch.rand((k, n, 2))
    first = dict(position=pos, attempted=torch.zeros((k, 3), dtype=torch.int64),
                 accepted=torch.zeros((k, 3), dtype=torch.int64))
    last = dict(position=pos.clone(), attempted=torch.tensor([[0, 50, 50]] * k),
                accepted=torch.tensor([[0, 40, 40]] * k))
    assert CELL.displacements({"pool": POOL}) == [0]
    assert CELL.frozen_excess(first, last, n, [0]) == 0.0
    assert CELL.frozen_excess(first, last, n, [0, 1, 2]) > 0.8


def small_start(n=100, chains=4, seed=7):
    g = generate.start(dict(CFG["system"], n=n), CFG["start"], chains, seed, torch.device("cpu"))
    box = torch.full((chains, 2), g["box_side"], dtype=torch.float64)
    return g["position"], g["species"], box, torch.full((chains,), T, dtype=torch.float64)


def test_swap_sampler_ledger_and_composition():
    pos, sp, box, temp = small_start()
    x, s, l0, l1, att, acc = swap_sampler.metropolis(pos, sp, box, temp, CFG["potential"], POOL, 300,
                                                     torch.Generator().manual_seed(1))
    gap = (l1 - l0) - (total_energy(x, s, box, CFG["potential"]) - total_energy(pos, sp, box, CFG["potential"]))
    assert float(gap.abs().max()) < 1e-9
    assert bool((s != sp).any()) and bool((acc[:, 1:] > 0).all())
    for k in range(3):
        assert torch.equal((s == k).sum(dim=1), (sp == k).sum(dim=1))
    assert torch.equal(att.sum(dim=1), torch.full((4,), 300))


def test_swap_sampler_displacements_accept_as_the_plain_sampler():
    pos, sp, box, temp = small_start(chains=8)
    disp = [dict(POOL[0], args={"sigma": 0.1})]
    *_, a1, c1 = swap_sampler.metropolis(pos, sp, box, temp, CFG["potential"], disp, 2000,
                                         torch.Generator().manual_seed(2))
    *_, a2, c2 = sampler.metropolis(pos, sp, box, temp, CFG["potential"], 0.1, 2000,
                                    torch.Generator().manual_seed(3), compute=torch.float64)
    assert abs(float(c1.sum() / a1.sum()) - float(c2.sum() / a2.sum())) < 0.02


def boltzmann_gap(policy, temperature=1.5, chains=4000, steps=60):
    """Largest gap between the share of chains in each species arrangement
    of five fixed particles after `steps` swaps and its Boltzmann weight,
    and the sampling error's three standard deviations."""
    n = 5
    x0 = torch.tensor([[0.0, 0.0], [1.1, 0.1], [0.1, 1.05], [1.2, 1.15], [2.2, 0.6]], dtype=torch.float64)
    x0 = (x0 + 0.1 * torch.rand((n, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64))[None]
    box = torch.full((chains, 2), 3.3, dtype=torch.float64)
    base = [1, 1, 2, 2, 2]
    arrangements = sorted(set(itertools.permutations(base)))
    u = total_energy(x0.expand(len(arrangements), n, 2), torch.tensor(arrangements), box[:len(arrangements)],
                     CFG["potential"])
    p = torch.softmax(-u / temperature, 0)
    pool = [{"move": "discrete_swap", "args": {"s1": 1, "s2": 2, "probability": 1.0, "policy": policy,
                                                "theta1": 0.7, "theta2": -1.3}}]
    _, s, *_ = swap_sampler.metropolis(x0.expand(chains, n, 2).clone(), torch.tensor(base).expand(chains, n).clone(),
                                       box, torch.full((chains,), temperature, dtype=torch.float64),
                                       CFG["potential"], pool, steps, torch.Generator().manual_seed(1))
    seen = torch.tensor([arrangements.index(tuple(r)) for r in s.tolist()])
    h = torch.bincount(seen, minlength=len(arrangements)).double() / chains
    return float((h - p).abs().max()), 3 * math.sqrt(float(p.max()) / chains)


@pytest.mark.parametrize("policy", ["double_uniform", "energy_bias"])
def test_swaps_sample_boltzmann(policy):
    gap, tol = boltzmann_gap(policy)
    assert gap < tol


def test_swaps_without_hastings_do_not(monkeypatch):
    """The control of the test above: EnergyBias with log q_rev = log q_fwd."""
    monkeypatch.setattr(swap_sampler, "log_pick", lambda e, species, s, theta, k: torch.zeros_like(theta))
    gap, tol = boltzmann_gap("energy_bias")
    assert gap > 2 * tol

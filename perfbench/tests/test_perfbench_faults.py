"""The check against faults of the timed path: a run at a small size on the
CPU (the look for a card skipped), driven through the harness as on the
chip, with the program's step broken underneath. Each fault has to turn
`correct` false by the number that catches it:

- a step that returns its state unchanged: every chain's counter;
- half of the batch left out: those chains' counters;
- a step that keeps every chain's positions and ledger while its counters
  advance: the frozen excess;
- a step that rejects every move (counters of attempts advance, state and
  accepts stay): the acceptance against the reference sampler's;
- proposals twice as wide as the traffic states: the acceptance;
- an answer altered where it is produced (a particle moved after the step
  with no energy booked): the ledger's drift against the reference.

One chip holds every cell, and no chain exchanges anything with another,
so there is no exchange between chips to leave out.
"""

import copy
import dataclasses
import time

import pytest
import torch

from perfbench import cell as CELL
from perfbench import spec

CPU = torch.device("cpu")


def small(name: str) -> spec.Cell:
    """The cell at the least size its grid and outputs allow on the CPU."""
    c = spec.cell(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.traffic.update(chains=4, burn_in_steps=2, probe_steps=2, reference_chains=4, output_interval=3,
                     reference_steps=400)
    if c.config["sampler"]["parallel_moves"]:
        c.config["system"]["n"] = 1300  # 4 cells per dimension
        c.config["sampler"]["list_parameters"].update(inner=4, rebin_every=2)
    else:
        c.config["system"]["n"] = 100
    return c


def mixed(new, old, k: int):
    """`new` in its first k chains and `old` in the rest (every tensor with
    the batch's leading axis), recursively through the state's dataclasses."""
    B = new.system.n_chains if hasattr(new, "system") else new.n_chains

    def mix(a, b):
        if isinstance(a, torch.Tensor) and a.dim() > 0 and a.shape[0] == B:
            return torch.cat([a[:k], b[k:]])
        if dataclasses.is_dataclass(a) and not isinstance(a, type):
            return dataclasses.replace(a, **{f.name: mix(getattr(a, f.name), getattr(b, f.name))
                                             for f in dataclasses.fields(a)})
        return a

    return mix(new, old)


def altered(state):
    """Particle 0 of every chain moved by 0.3 after the step, no ΔE booked."""
    sys_ = state.system
    pos = sys_.position.clone()
    pos[:, 0, 0] += 0.3
    return state.replace(system=sys_.replace(position=pos))


FAULTS = {
    "unchanged": lambda step, mc, *a: mc,
    "half_batch": lambda step, mc, *a: mixed(step(mc, *a), mc, mc.system.n_chains // 2),
    "frozen": lambda step, mc, *a: step(mc, *a).replace(system=mc.system),
    "reject_all": lambda step, mc, *a: step(mc, *a).replace(system=mc.system, accepted=mc.accepted),
    "sigma_2x": None,  # the window's pool, widened (break_program)
    "altered": lambda step, mc, *a: altered(step(mc, *a)),
}


def break_program(monkeypatch, fault):
    """Break the step of the window's Simulation (the one with outputs);
    set-up's burn-in and probe run the program as it is."""
    from particlesmc_tpu_torch.moves import base, checkerboard, kernel

    def wrap(make):
        def build(*args, **kw):
            step = make(*args, **kw)
            return lambda mc, *a: FAULTS[fault](step, mc, *a)

        return build

    real = CELL.simulation

    def simulation(state, table, pool, *args, outputs=(), **kw):
        if outputs and FAULTS[fault] is None:
            pool = tuple(base.displacement(sigma=2.0 * dict(m.params)["sigma"]) for m in pool)
        elif outputs:
            monkeypatch.setattr(checkerboard, "build_hyper_sweep_fn", wrap(checkerboard.build_hyper_sweep_fn))
            monkeypatch.setattr(kernel, "build_run_fn", wrap(kernel.build_run_fn))
        return real(state, table, pool, *args, outputs=outputs, **kw)

    monkeypatch.setattr(CELL, "simulation", simulation)


CELLS = ["ka3d-n10k.cb-b256", "jbb2d-n1000.seq-b64"]


@pytest.fixture(scope="module")
def sound():
    """The unbroken runs of each cell at the small size."""
    return {name: CELL.run_cell(small(name), 12345, 1.0, False, CPU, time.perf_counter()) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_counts_and_composition(sound, name):
    checks = sound[name]["checks"]
    assert checks["counter_mismatch"][0] == 0
    assert checks["species_changed"][0] == 0
    assert checks["nonfinite"][0] == 0
    assert checks["frozen_excess"][0] < checks["frozen_excess"][1]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_turns_correct_false(sound, monkeypatch, name, fault):
    break_program(monkeypatch, fault)
    out = CELL.run_cell(small(name), 12345, 1.0, False, CPU, time.perf_counter())
    assert out["correct"] is False
    checks = out["checks"]
    B = small(name).traffic["chains"]
    if fault == "unchanged":
        assert checks["counter_mismatch"][0] == B
    elif fault == "half_batch":
        assert checks["counter_mismatch"][0] >= B - B // 2  # a tie may count every chain
    elif fault == "frozen":
        assert checks["frozen_excess"][0] > checks["frozen_excess"][1]
        assert checks["counter_mismatch"][0] == 0
    elif fault in ("reject_all", "sigma_2x"):
        gap, limit = checks["acceptance_gap"]
        assert gap > limit and gap > 3 * sound[name]["checks"]["acceptance_gap"][0]
    else:
        drift, limit = checks["ledger_drift"]
        assert drift > limit and drift > 100 * sound[name]["checks"]["ledger_drift"][0]


@pytest.mark.parametrize("attempted,skips,bad", [
    ([30, 30, 30], [0, 0, 0], 0),  # 10 per step over 3 steps, N = 10
    ([36, 36, 24], [0, 0, 1], 0),  # a schedule of 12 per step; one chain skipped a step
    ([30, 30, 33], [0, 0, 0], 1),  # one chain off the common count
    ([30, 30, 25], [0, 0, 1], 1),  # a skipped chain short by less than a step
    ([27, 27, 27], [0, 0, 0], 3),  # fewer than N per step
    ([31, 31, 31], [0, 0, 0], 3),  # not a whole number per step
    ([0, 0, 0], [0, 0, 0], 3),  # no step ran
    ([20, 20, 20], [1, 1, 1], 3),  # every chain skipped: nothing to hold them to
])
def test_counter_check_knows_no_schedule(attempted, skips, bad):
    """Counts are held to what any schedule gives, not to one schedule."""
    att, skp = torch.tensor(attempted), torch.tensor(skips)
    assert CELL.counter_mismatch(att, skp, steps=3, n=10) == bad

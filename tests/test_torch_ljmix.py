"""The binary LJ mixture of the reference's validation gate
(examples/lj-mixture/run-validation.py; Rowley et al.,
doi:10.1023/A:1022614200488) as the port's named table
`tables.BinaryLJMixture`, on the CPU:

- the table is the script's [model."i-j"] blocks, field by field, as the
  port and the JAX package build them from the TOML;
- its dense total energy is the benchmark's plain reference form's
  (perfbench/reference/forms/lennard_jones_uniform_cut.py) in float64;
- a short checkerboard run with the script's pool (displacements and
  in-cell DoubleUniform swaps) keeps its ledger equal to the dense
  recompute, accepts swaps, and counts one `cb.submove_calls.double_uniform`
  per swap slot of the schedule.
"""

import dataclasses
import importlib.util
import math
import os
import tomllib

import numpy as np
import pytest
import torch

from particlesmc_tpu.models import tables as JT
from particlesmc_tpu_torch import tracing
from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as CBK
from perfbench.reference.energy import total_energy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "lj-mixture", "run-validation.py")
T, RCUT = 1.2183, 4.0
# the reference form's statement of the one cutoff: rcut_over_sigma times
# the largest sigma (perfbench/configs/ljmix-n4096.json)
POTENTIAL = {
    "form": "lennard_jones_uniform_cut", "eps": [[1.0, 1.1523], [1.1523, 1.3702]],
    "sigma": [[1.0, 1.0339], [1.0339, 1.064]], "rcut_over_sigma": 4.0 / 1.064, "shifted": False,
}
SWAP_CALLS = "cb.submove_calls.double_uniform"


def script_blocks(tmp_path) -> dict:
    """The [model."i-j"] blocks of the params.toml the script writes for
    its densest point."""
    spec = importlib.util.spec_from_file_location("ljmix_validation", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = mod.write_params(str(tmp_path), "start.xyz", T, 0.8, RCUT, 10, 0.05, 8, 4096)
    with open(path, "rb") as f:
        return tomllib.load(f)["model"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_table_is_the_scripts_blocks(tmp_path, package):
    blocks = script_blocks(tmp_path)
    named = TT.BinaryLJMixture(device="cpu")
    if package == "port":
        other = {f.name: getattr(TT.model_matrix_from_dict(blocks, 2, device="cpu"), f.name).numpy()
                 for f in dataclasses.fields(TT.PairTable)}
    else:
        jt = JT.model_matrix_from_dict(blocks, 2)
        other = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(TT.PairTable)}
    for f in dataclasses.fields(TT.PairTable):
        np.testing.assert_array_equal(getattr(named, f.name).numpy(), other[f.name], err_msg=f.name)
    assert named.max_cutoff == RCUT
    assert float(named.shift.abs().max()) == 0.0
    assert TT.resolve_model("BinaryLJMixture()", 2, device="cpu").eps4.tolist() == named.eps4.tolist()


def random_mixture(n, rho, chains, seed):
    """Uniform random positions (no two closer than sigma_1) of equal
    species shares, float64 on the CPU."""
    rng = np.random.default_rng(seed)
    L = (n / rho) ** (1 / 3)
    pos = np.empty((chains, n, 3))
    for b in range(chains):
        k = 0
        while k < n:
            x = rng.uniform(0, L, 3)
            d = pos[b, :k] - x
            d -= L * np.round(d / L)
            if k == 0 or float(np.min(np.sum(d * d, axis=-1))) > 1.0:
                pos[b, k] = x
                k += 1
    species = np.stack([rng.permutation(np.arange(n) % 2) for _ in range(chains)])
    return pos, species, L


def test_dense_energy_is_the_reference_forms():
    """300 particles at rho 0.5 (a box of 8.43 > 2 rcut, so the minimum
    image sees every pair within the cutoff): ~45k pair terms a chain, so
    float64 rounding of the sums stays far below 1e-10 relative."""
    pos, species, L = random_mixture(300, 0.5, 2, seed=1)
    assert L > 2 * RCUT
    table = TT.BinaryLJMixture(device="cpu")
    p, s = torch.tensor(pos), torch.tensor(species)
    box = torch.full((2, 3), L, dtype=torch.float64)
    port = total_energy_dense(p, s, box, table)
    ref = total_energy(p, s, box, POTENTIAL)
    assert bool((ref < 0).all())  # attractive pairs within the cutoff dominate
    torch.testing.assert_close(port, ref, rtol=1e-10, atol=0.0)


def checkerboard_run(tmp_path, steps=4, n=1000, rho=0.2, chains=2, inner=4, rebin=2):
    """A short checkerboard run of the script's pool in float64 on a box of
    17.1 > 4 cutoffs (a 4^3 grid) at a low density."""
    pos, species, L = random_mixture(n, rho, chains, seed=2)
    assert L >= 4 * RCUT
    table = TT.BinaryLJMixture(device="cpu")
    state = initialize_energy(make_system(pos, species, rho, T, device="cpu"), table)
    pool = (TMB.displacement(0.05, 0.9), TMB.discrete_swap(0, 1, 0.1))
    chains_ = Chains(states=state, table=table, list_type="dense",
                     list_parameters={"cap": 48, "inner": inner, "rebin_every": rebin}, n_chains=chains)
    algos = [dict(algorithm="Metropolis", pool=pool, seed=5, parallel_moves=True),
             dict(algorithm="StoreAcceptance", scheduler=[0, steps])]
    sim = Simulation(chains_, algos, steps, path=str(tmp_path))
    calls0 = tracing.counters().get(SWAP_CALLS, 0)
    sim.run()
    return sim, state, pool, tracing.counters().get(SWAP_CALLS, 0) - calls0


def test_checkerboard_run_ledger_swaps_and_counter(tmp_path):
    steps, n, inner = 4, 1000, 4
    sim, start, pool, calls = checkerboard_run(tmp_path, steps=steps, n=n, inner=inner)
    mc = sim.mc
    system = mc.system
    recomputed = total_energy_dense(system.position, system.species, system.box, TT.BinaryLJMixture(device="cpu"))
    torch.testing.assert_close(system.energy, recomputed, rtol=1e-9, atol=1e-9)
    assert bool((system.species != start.species).any())
    assert bool((mc.accepted[:, 1] > 0).all())  # every chain accepted a swap
    for k in range(2):  # the composition stays
        assert torch.equal((system.species == k).sum(dim=1), (start.species == k).sum(dim=1))
    # one count per swap slot of the schedule: rounds of 2^d colours with
    # `inner` slots each, the schedule's swap slots in every round
    spec = CBK.make_cb_spec(system.box[0].numpy(), TT.BinaryLJMixture(device="cpu").max_cutoff, n, cap=48)
    C = 2**3
    rounds = max(1, math.ceil(n / (spec.n_active * inner * C)))
    swap_slots = int((CBK._slot_schedule(pool, C, inner) == 1).sum())
    assert swap_slots > 0 and calls == steps * rounds * swap_slots
    # and each call counts every occupied active cell of every chain
    assert bool((mc.attempted[:, 1] <= calls * spec.n_active).all())

"""The port's observables against the JAX package's: the structural
functions of analysis/structure.py, the virial and pressure of
core/energy.py, the pressure and chain_correlation callbacks, and the
profile_dir trace of a run."""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.analysis import structure as JA
from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.engine import callbacks as JC
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu_torch import cli
from particlesmc_tpu_torch.analysis import structure as TA
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB

from .helpers import molecular_system
from .test_torch_engine import PARAMS, _write_config
from .test_torch_inputs import lattice

torch.set_num_threads(1)


def _frames(m=3, n=200, d=3, L=6.0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, L, (m, n, d)), np.full(d, L), (rng.random(n) < 0.3).astype(np.int64)


@pytest.mark.parametrize("pair", [None, (0, 0), (0, 1)], ids=["all", "AA", "AB"])
def test_radial_distribution_matches_jax(pair):
    """g(r) of seeded frames within 1e-12 of the JAX package's, from the
    same histogram counts; a tensor input stays on its device."""
    pos, box, sp = _frames()
    r_j, g_j = JA.radial_distribution(pos, box, nbins=40, rmax=2.9, species=sp, pair=pair)
    r_t, g_t = TA.radial_distribution(pos, box, nbins=40, rmax=2.9, species=sp, pair=pair, device="cpu")
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=0)
    # the counts behind g: g * n_ref * rho * shell is an integer in both
    n_a = pos.shape[1] if pair is None else int((sp == pair[0]).sum())
    n_b = pos.shape[1] if pair is None else int((sp == pair[1]).sum())
    edges = np.linspace(0.0, 2.9, 41)
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    scale = pos.shape[0] * n_a * (n_b / np.prod(box)) * shell
    np.testing.assert_array_equal(np.rint(g_t * scale), np.rint(g_j * scale))
    assert np.rint(g_t * scale).sum() > 100
    _, g_dev = TA.radial_distribution(torch.tensor(pos), torch.tensor(box), nbins=40, rmax=2.9, species=sp, pair=pair)
    np.testing.assert_array_equal(g_dev, g_t)


@pytest.mark.parametrize("fn", ["radial_distribution", "self_intermediate_scattering", "unwrap_trajectory",
                                "mean_squared_displacement"])
def test_numpy_input_defaults_to_the_card(fn, monkeypatch):
    """A numpy input goes to the card unless the caller names a device, as
    at every entry point of the port: without CUDA it raises, never running
    on the CPU quietly; a CPU tensor stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, box, _ = _frames(m=3, n=20)
    args = {"radial_distribution": (box,), "self_intermediate_scattering": (box, 7.4),
            "unwrap_trajectory": (box,), "mean_squared_displacement": ()}[fn]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(TA, fn)(pos, *args)
    want = getattr(TA, fn)(pos, *args, device="cpu")
    got = getattr(TA, fn)(torch.tensor(pos), *args)
    np.testing.assert_array_equal(got[-1] if fn == "radial_distribution" else got,
                                  want[-1] if fn == "radial_distribution" else want)


def test_dynamics_match_jax():
    """F_s(k, t), the unwrapped trajectory and the MSD of a folded random
    walk within 1e-12 of the JAX package's."""
    rng = np.random.default_rng(4)
    box = np.array([5.0, 6.0, 7.0])
    truth = np.cumsum(rng.normal(0.0, 0.3, (12, 30, 3)), axis=0) + rng.uniform(0, 5.0, (1, 30, 3))
    folded = truth - box * np.floor(truth / box)
    np.testing.assert_allclose(TA.unwrap_trajectory(folded, box, device="cpu"), JA.unwrap_trajectory(folded, box), atol=1e-12)
    np.testing.assert_allclose(
        TA.mean_squared_displacement(folded, box, device="cpu"), JA.mean_squared_displacement(folded, box), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(TA.mean_squared_displacement(truth, device="cpu"), JA.mean_squared_displacement(truth), rtol=1e-12)
    unwrapped = JA.unwrap_trajectory(folded, box)
    for k_mod in (2.0, 7.4):
        np.testing.assert_allclose(
            TA.self_intermediate_scattering(unwrapped, box, k_mod, device="cpu"),
            JA.self_intermediate_scattering(unwrapped, box, k_mod), rtol=1e-12, atol=1e-12,
        )


@pytest.mark.slow
def test_gr_ideal_gas_is_flat():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 12.0, (4000, 3))
    r, g = TA.radial_distribution(pos, np.full(3, 12.0), nbins=30, rmax=5.0, device="cpu")
    assert abs(np.mean(g[5:]) - 1.0) < 0.05


def test_gr_species_resolved_lattice():
    """A simple cubic lattice: the first peak at the spacing, nothing
    below it."""
    g1 = np.stack(np.meshgrid(*[np.arange(4) * 1.0] * 3, indexing="ij"), -1).reshape(-1, 3)
    r, g = TA.radial_distribution(g1, np.full(3, 4.0), nbins=40, rmax=1.9, device="cpu")
    first_peak = np.flatnonzero(g > 5.0)[0]
    assert abs(r[first_peak] - 1.0) < 0.06
    assert np.all(g[r < 0.9] == 0.0)
    sp = np.arange(64) % 2  # the two species of a lattice, resolved
    r_j, g_j = JA.radial_distribution(g1, np.full(3, 4.0), nbins=40, rmax=1.9, species=sp, pair=(0, 1))
    _, g_t = TA.radial_distribution(g1, np.full(3, 4.0), nbins=40, rmax=1.9, species=sp, pair=(0, 1), device="cpu")
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12)


def test_fskt_and_msd_static_frames():
    pos = np.tile(np.random.default_rng(1).uniform(0, 10, (50, 3)), (5, 1, 1))
    np.testing.assert_allclose(TA.self_intermediate_scattering(pos, np.full(3, 10.0), k_mod=7.4, device="cpu"), 1.0, atol=1e-12)
    np.testing.assert_allclose(TA.mean_squared_displacement(pos, device="cpu"), 0.0, atol=1e-15)


def test_msd_unwraps_folded_boundary_crossings():
    """A walker crossing the periodic boundary: the folded trajectory's MSD
    with `box` matches the true one, and is badly wrong without it."""
    rng = np.random.default_rng(7)
    box = np.full(3, 5.0)
    steps = rng.normal(0.0, 0.4, (200, 20, 3))
    truth = np.concatenate([np.zeros((1, 20, 3)), np.cumsum(steps, axis=0)]) + rng.uniform(0, 5.0, (1, 20, 3))
    folded = truth - box * np.floor(truth / box)
    msd_truth = TA.mean_squared_displacement(truth, device="cpu")
    np.testing.assert_allclose(TA.mean_squared_displacement(folded, box=box, device="cpu"), msd_truth, rtol=1e-12)
    unwrapped = TA.unwrap_trajectory(folded, box, device="cpu")
    np.testing.assert_allclose(unwrapped - unwrapped[0], truth - truth[0], atol=1e-9)
    assert abs(TA.mean_squared_displacement(folded, device="cpu")[-1] - msd_truth[-1]) > 0.5 * msd_truth[-1]


def _ka_chains(n=150, d=3, seeds=(0, 1), density=1.2):
    pos = np.stack([lattice(n, d, density, s)[0] for s in seeds])
    sp = np.stack([lattice(n, d, density, s)[1] for s in seeds])
    return pos, sp, density


def test_virial_and_pressure_match_jax_ka():
    """particle_virial_nogather, total_virial_dense and pressure on two
    KA-LJ chains within rtol 1e-9 of the JAX package's."""
    pos, sp, rho = _ka_chains()
    st = make_system(pos, sp, rho, [1.0, 0.8], device="cpu")
    table = TT.KobAndersen(device="cpu")
    jt = JT.KobAndersen()
    k = torch.arange(0, 150, 7).expand(2, -1)
    w_k = TE.particle_virial_nogather(k, st.position, st.species, st.box, table)
    w = TE.total_virial_dense(st.position, st.species, st.box, table, chunk=64)
    p = TE.pressure(st.position, st.species, st.box, table, st.density, st.temperature)
    for b, temp in enumerate((1.0, 0.8)):
        js = j_make_system(pos[b], sp[b], rho, temp)
        w_kj = [float(JE.particle_virial_nogather(int(i), js.position, js.species, js.box, jt)) for i in k[b]]
        np.testing.assert_allclose(w_k[b].numpy(), w_kj, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(w[b]), float(JE.total_virial_dense(js.position, js.species, js.box, jt)),
                                   rtol=1e-9)
        p_j = float(JE.pressure(js.position, js.species, js.box, jt, js.density, js.temperature))
        np.testing.assert_allclose(float(p[b]), p_j, rtol=1e-9)


def test_virial_and_pressure_match_jax_molecular():
    """The same on molecule.npz (1000 trimers): bonded partners leave the
    pair virial and add the bond virial."""
    js, jt, fx, _, _ = molecular_system(with_energy=False)
    st = make_system(
        fx["position"], fx["species"], float(fx["density"]), float(fx["temperature"]),
        molecule=fx["molecule"], bonds=np.asarray(js.bonds), box=fx["box"], device="cpu",
    )
    table = TT.resolve_model(str(fx["model"]), 3, device="cpu")
    k = torch.arange(0, 3000, 97)[None]
    w_k = TE.particle_virial_nogather(k, st.position, st.species, st.box, table, st.bonds)
    w_kj = [float(JE.particle_virial_nogather(int(i), js.position, js.species, js.box, jt, js.bonds)) for i in k[0]]
    np.testing.assert_allclose(w_k[0].numpy(), w_kj, rtol=1e-9, atol=1e-9)
    p = TE.pressure(st.position, st.species, st.box, table, st.density, st.temperature, st.bonds)
    p_j = float(JE.pressure(js.position, js.species, js.box, jt, js.density, js.temperature, js.bonds))
    np.testing.assert_allclose(float(p[0]), p_j, rtol=1e-9)
    w = TE.total_virial_dense(st.position, st.species, st.box, table, st.bonds)
    np.testing.assert_allclose(
        float(w[0]), float(JE.total_virial_dense(js.position, js.species, js.box, jt, js.bonds)), rtol=1e-9
    )


def test_lj_pressure_sane():
    """A dilute LJ gas approaches the ideal gas; a dense lattice is strongly
    repulsive."""
    table = TT.KobAndersen(device="cpu")
    rng = np.random.default_rng(0)
    n, d = 216, 3

    def P(density, temperature):
        L = (n / density) ** (1 / d)
        per = int(np.ceil(n ** (1 / d)))
        a = L / per
        grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n]
        pos = grid + rng.uniform(-0.02 * a, 0.02 * a, (n, d))
        st = make_system(pos, np.ones(n, np.int64), density, temperature, device="cpu")
        return float(TE.pressure(st.position, st.species, st.box, table, st.density, st.temperature)[0])

    assert abs(P(0.01, 2.0) - 0.01 * 2.0) < 0.01
    assert P(1.2, 2.0) > 5.0


def test_pressure_callback_through_simulation_matches_jax(tmp_path):
    """StoreCallbacks with "pressure" on two KA chains through the port's
    Simulation (checkerboard): each row equals the JAX package's pressure of
    that step's state (the start, and the end)."""
    pos, sp, rho = _ka_chains(n=150, d=2, density=1.2)
    table = TT.KobAndersen(device="cpu")
    st = TE.initialize_energy(make_system(pos, sp, rho, 1.0, device="cpu"), table)
    chains = Chains(states=st, table=table, list_type="cell", list_parameters={"inner": 2}, n_chains=2)
    algos = [
        dict(algorithm="Metropolis", pool=(TMB.displacement(0.08),), seed=3, parallel_moves=True),
        dict(algorithm="StoreCallbacks", callbacks=("pressure",), scheduler=[0, 2]),
    ]
    sim = Simulation(chains, algos, 2, path=str(tmp_path)).run()
    jt = JT.KobAndersen()
    for b in range(2):
        rows = np.loadtxt(tmp_path / "chains" / str(b + 1) / "pressure.dat")
        for step, state_pos in ((0, pos[b]), (2, sim.mc.system.position[b].numpy())):
            js = j_make_system(state_pos, sp[b], rho, 1.0)
            p_j = float(JE.pressure(js.position, js.species, js.box, jt, js.density, js.temperature))
            row = rows[rows[:, 0] == step][0]
            np.testing.assert_allclose(row[1], p_j, rtol=1e-9)


def test_chain_correlation_callback_matches_jax(tmp_path):
    """chain_correlation on molecule.npz's trimers (two chains, one with its
    species shuffled within each molecule) equals the JAX package's; an
    atomic system raises the JAX package's ValueError."""
    js, _, fx, ms, ml = molecular_system(with_energy=False)
    rng = np.random.default_rng(2)
    sp0 = np.asarray(fx["species"])
    sp1 = np.concatenate([rng.permutation(sp0[i:i + 3]) for i in range(0, len(sp0), 3)])
    table = TT.resolve_model(str(fx["model"]), 3, device="cpu")
    st = make_system(
        np.stack([fx["position"]] * 2), np.stack([sp0, sp1]), float(fx["density"]), float(fx["temperature"]),
        molecule=fx["molecule"], bonds=np.asarray(js.bonds), box=fx["box"], device="cpu",
    )
    chains = Chains(states=st, table=table, list_type="dense", n_chains=2,
                    mol_start=np.asarray(ms), mol_len=np.asarray(ml))
    algos = [dict(algorithm="Metropolis", pool=(TMB.displacement(0.05),), seed=1),
             dict(algorithm="StoreCallbacks", callbacks=("chain_correlation",), scheduler=[0])]
    Simulation(chains, algos, 0, path=str(tmp_path)).run()
    got = [float(np.loadtxt(tmp_path / "chains" / str(b + 1) / "chain_correlation.dat")[1]) for b in range(2)]
    jsim = types.SimpleNamespace(
        mc=types.SimpleNamespace(system=types.SimpleNamespace(
            molecule=jnp.asarray(st.molecule.numpy()), species=jnp.asarray(st.species.numpy()))),
        mol_len=np.asarray(ml),
    )
    want = JC.chain_correlation(jsim)
    np.testing.assert_allclose(got, want, rtol=1e-11)
    assert got[0] != got[1]
    atomic = Simulation(
        Chains(states=TE.initialize_energy(make_system(*lattice(16, 2, 0.5, 0), 0.5, 1.0, device="cpu"),
                                           TT.JBB(device="cpu")),
               table=TT.JBB(device="cpu"), list_type="dense", n_chains=1),
        [algos[0], algos[1]], 0, path=str(tmp_path / "atomic"),
    )
    with pytest.raises(ValueError, match="requires a molecular system"):
        atomic.run()


def test_cli_profile_dir_writes_trace(tmp_path):
    """`profile_dir` in [simulation]: the whole run executes under
    torch.profiler and leaves a non-empty trace file there."""
    _write_config(tmp_path / "config.xyz")
    trace = tmp_path / "trace"
    text = PARAMS.format(out=tmp_path / "out").replace("seed = 10", f'seed = 10\nprofile_dir = "{trace}"')
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(text)
    assert cli.main([str(ptoml), "--device", "cpu"]) == 0
    files = [f for f in os.listdir(trace) if f.endswith(".json")]
    assert files and os.path.getsize(trace / files[0]) > 0
    assert (tmp_path / "out" / "chains" / "1" / "energy.dat").exists()

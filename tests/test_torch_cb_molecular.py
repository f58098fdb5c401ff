"""Molecular systems in the port (state, energy, I/O and the molecular
checkerboard sub-moves) against the JAX package, on the CPU.

The hyper-sweep parity call runs the trimer melt of tests/test_cb_molecular.py
with the same shift and draws through both packages; neither package sends a
molecular pool through its kernel, so both take the same sub-move path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core import state as JS
from particlesmc_tpu.io import formats as JF
from particlesmc_tpu.io import loader as JL
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu_torch import convert
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core import state as TS
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io import formats as TF
from particlesmc_tpu_torch.io import loader as TL
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .helpers import load_fixture, molecular_system
from .test_cb_molecular import _trimer_melt
from .test_torch_cb_moves import reference_draws

torch.set_num_threads(1)


def _port_system(states):
    """JAX molecular SystemStates (one per chain) as one batched port state."""
    def stack(f):
        return np.stack([np.asarray(getattr(s, f)) for s in states])

    return convert.system_from_numpy(
        stack("position"), stack("species"), stack("box"), stack("density"),
        stack("temperature"), stack("energy"), device="cpu",
        molecule=stack("molecule"), bonds=stack("bonds"),
    )


def test_molecule_golden_energy():
    """The reference's gate: 25.65865662277199 per particle for
    molecule.npz (N = 3000 trimers, Trimer model), and the JAX package's
    per-particle energies."""
    fx = load_fixture("molecule.npz")
    n = len(fx["species"])
    bonds = TS.bonds_from_pairs(fx["bond_pairs"] - 1, n)
    assert bonds == JS.bonds_from_pairs(fx["bond_pairs"] - 1, n)
    st = TS.make_system(
        fx["position"], fx["species"], float(fx["density"]), float(fx["temperature"]),
        molecule=fx["molecule"], bonds=bonds, box=fx["box"], device="cpu",
    )
    table = TT.resolve_model(str(fx["model"]), 3, device="cpu")
    st = TE.initialize_energy(st, table)
    assert float(st.energy[0]) / n == pytest.approx(float(fx["golden_energy_per_particle"]), abs=1e-6)
    js, jt, _, ms, ml = molecular_system(with_energy=False)
    np.testing.assert_array_equal(st.bonds[0].numpy(), np.asarray(js.bonds))
    np.testing.assert_array_equal(st.molecule[0].numpy(), np.asarray(js.molecule))
    t_ms, t_ml = TS.mol_table(st.molecule[0].numpy())
    np.testing.assert_array_equal(t_ms, ms)
    np.testing.assert_array_equal(t_ml, ml)
    rows = slice(0, 400)  # the JAX package's per-particle energies on a slice
    e_t = TE.per_particle_energies(st.position, st.species, st.box, table, st.bonds)[0, rows]
    e_j = jax.vmap(
        lambda k: JE.particle_energy_nogather(k, js.position, js.species, js.box, jt, js.bonds)
    )(jnp.arange(400))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-12, atol=1e-12)


def test_loader_and_formats_match_jax(tmp_path):
    """A molecular XYZ and EXYZ last frame with its bond section: the port
    writes what the JAX package writes, and loads it to the same chains."""
    fx = load_fixture("molecule.npz")
    pairs = [tuple(p) for p in fx["bond_pairs"]]
    args = (fx["species"], fx["position"], fx["box"], 0)
    texts = {
        "xyz": (TF.write_xyz_frame(*args, fx["density"], 2.0, molecule=fx["molecule"], bond_pairs=pairs),
                JF.write_xyz_frame(*args, fx["density"], 2.0, molecule=fx["molecule"], bond_pairs=pairs)),
        "exyz": (TF.write_exyz_frame(*args, molecule=fx["molecule"], bond_pairs=pairs),
                 JF.write_exyz_frame(*args, molecule=fx["molecule"], bond_pairs=pairs)),
    }
    for fmt, (t_text, j_text) in texts.items():
        assert t_text == j_text
        path = tmp_path / f"frame.{fmt}"
        path.write_text(t_text)
        cfg = TF.read_configuration(str(path))
        np.testing.assert_array_equal(cfg["bond_pairs"], fx["bond_pairs"])
        np.testing.assert_array_equal(cfg["molecule"], fx["molecule"])
        args_l = {"temperature": 2.0, "model": "Trimer", "nsim": 2}
        tc = TL.load_chains(str(path), args=args_l, device="cpu")
        jc = JL.load_chains(str(path), args=args_l)
        assert tc.n_chains == jc.n_chains == 2
        np.testing.assert_array_equal(tc.states.bonds.numpy(), np.asarray(jc.states.bonds))
        np.testing.assert_array_equal(tc.states.molecule.numpy(), np.asarray(jc.states.molecule))
        np.testing.assert_allclose(tc.states.energy.numpy(), np.asarray(jc.states.energy), rtol=1e-12)
        np.testing.assert_array_equal(tc.mol_start, jc.mol_start)
        np.testing.assert_array_equal(tc.mol_len, jc.mol_len)
    with pytest.raises(TF.FormatError):
        TF.write_lammps_frame(*args, bond_pairs=pairs)


def test_rebin_molecular_planes_match_jax():
    """The molecular payload planes (id, bond partners, molecule start and
    length) bin as in the JAX package."""
    st, table = _trimer_melt()
    spec = JCB.make_cb_spec(np.asarray(st.box), JT.interaction_range(table), st.n_particles, occ_factor=4.0)
    tspec = TCB.make_cb_spec(np.asarray(st.box), TT.interaction_range(TT.Trimer(device="cpu")),
                             st.n_particles, occ_factor=4.0)
    assert tspec == TCB.CBSpec(spec.ncells, spec.cap) and spec.ncells == (4, 4, 4)
    shift = np.asarray([0.3, 1.7, 2.2])
    planes, idx, slot, ovf = TCB.rebin(_port_system([st]), tspec, torch.tensor(shift)[None])
    jp, ji, js, jo = JCB.rebin(st, spec, jnp.asarray(shift))
    assert planes.shape[1] == 3 + 1 + 3 + st.bonds.shape[1]
    np.testing.assert_array_equal(planes[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(js))
    assert bool(ovf[0]) == bool(jo)


def test_molecular_hyper_sweep_matches_jax():
    """One call of a Displacement + MoleculeFlip pool on the trimer melt
    (64 trimers at rho = 0.4, a 4^3 grid, inner 1), two chains, shared draws: same
    counters and species, positions within 1e-9, energy within rtol 1e-9,
    and a ledger equal to the dense recompute with bonds."""
    seeds = (3, 4)
    sts = [_trimer_melt(seed=s)[0] for s in seeds]
    jt = JT.Trimer(jnp.float64)
    n = sts[0].n_particles
    spec = JCB.make_cb_spec(np.asarray(sts[0].box), JT.interaction_range(jt), n, occ_factor=4.0)
    maxb = int(sts[0].bonds.shape[1])
    inner = 1
    pool_j = (JMB.displacement(0.1, probability=0.6), JMB.molecule_flip(probability=0.4))
    pool_t = (TMB.displacement(0.1, probability=0.6), TMB.molecule_flip(probability=0.4))
    fn = jax.jit(jax.vmap(
        JCB.build_hyper_sweep_fn(spec, jt, n, inner=inner, pool=pool_j, max_bonds=maxb), in_axes=(0, None)
    ))
    cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=2) for st, s in zip(sts, seeds)]
    out_j = fn(jax.tree.map(lambda *x: jnp.stack(x), *cbs), JMB.init_pool_params(pool_j))

    d, C, A = 3, 8, spec.n_active
    R = max(1, -(-n // (A * inner * C)))
    draws = [reference_draws(cb.key, d, R, C, inner, A, True) for cb in cbs]
    draws = {k: torch.tensor(np.stack([dr[k] for dr in draws])) for k in draws[0]}
    system = _port_system(sts)
    fields = ("planes", "idx", "slot", "shift", "attempted", "accepted", "overflow", "skipped")
    cb_t = convert.cb_state_from_numpy(
        system, *(np.stack([np.asarray(getattr(cb, f)) for cb in cbs]) for f in fields)
    )
    table = TT.Trimer(device="cpu")
    hs = TCB.build_hyper_sweep_fn(TCB.CBSpec(spec.ncells, spec.cap), table, n, inner=inner,
                                  pool=pool_t, max_bonds=maxb)
    out_t = hs(cb_t, TMB.init_pool_params(pool_t, device="cpu"), **draws)

    np.testing.assert_array_equal(out_t.attempted.numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted.numpy(), np.asarray(out_j.accepted))
    np.testing.assert_array_equal(out_t.system.species.numpy(), np.asarray(out_j.system.species))
    np.testing.assert_allclose(out_t.system.position.numpy(), np.asarray(out_j.system.position), atol=1e-9)
    np.testing.assert_allclose(out_t.system.energy.numpy(), np.asarray(out_j.system.energy), rtol=1e-9)
    assert (out_t.accepted.sum(dim=0) > 0).all(), out_t.accepted
    st = out_t.system
    e_dense = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    # a flip permutes species within a molecule: every trimer keeps {0, 1, 2}
    sp = np.sort(st.species.numpy().reshape(2, -1, 3), axis=-1)
    assert (sp == np.arange(3)).all()
    assert (st.species != system.species).any()


def test_molecular_rejects_swap_pool():
    st, table = _trimer_melt(n_mol=48)
    spec = TCB.make_cb_spec(np.asarray(st.box), TT.interaction_range(TT.Trimer(device="cpu")), st.n_particles)
    pool = (TMB.discrete_swap(0, 1, probability=1.0),)
    with pytest.raises(ValueError, match="molecular"):
        TCB.build_hyper_sweep_fn(spec, TT.Trimer(device="cpu"), st.n_particles, pool=pool, max_bonds=2)


def test_engine_molecular_run(tmp_path):
    """The engine on a molecular system (the JAX package's own test pattern):
    a grid sized on the bond reach with occ_factor 4, finite energies, the
    ledger equal to a dense recompute with bonds, and a last frame with the
    molecule column and the bond section."""
    sts = [_trimer_melt(n_mol=48, density=0.35, seed=10 + k)[0] for k in range(2)]
    system = _port_system(sts)
    table = TT.Trimer(device="cpu")
    chains = TL.Chains(states=system, table=table, list_type="dense", n_chains=2,
                       list_parameters={"inner": 2})
    pool = (TMB.displacement(0.08, probability=0.8), TMB.molecule_flip(probability=0.2))
    sched = [0, 2, 4, 6]
    sim = Simulation(
        chains,
        [
            {"algorithm": "Metropolis", "pool": pool, "seed": 5, "parallel_moves": True},
            {"algorithm": "StoreCallbacks", "callbacks": ("energy",), "scheduler": sched},
            {"algorithm": "StoreLastFrames", "fmt": "xyz", "scheduler": [6]},
        ],
        6, path=str(tmp_path),
    ).run()
    box = np.asarray(sts[0].box)
    assert sim.cb_spec == TCB.make_cb_spec(box, TT.interaction_range(table), 144, occ_factor=4.0)
    assert sim.max_bonds == 2
    e = np.loadtxt(tmp_path / "chains" / "1" / "energy.dat")
    assert e.shape == (4, 2) and np.isfinite(e[:, 1]).all()
    st = sim.mc.system
    e_dense = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    assert int(sim.mc.accepted[:, 0].sum()) > 0
    last = TF.read_configuration(str(tmp_path / "chains" / "2" / "lastframe.xyz"))
    assert len(last["bond_pairs"]) == 144 and (last["molecule"] == np.repeat(np.arange(1, 49), 3)).all()
    # a flip needs a molecular system
    with pytest.raises(ValueError, match="does not support"):
        TCB.check_pool((TMB.molecule_flip(1.0),), molecular=False)


def test_state_helpers_match_jax():
    """pad_bonds, bonds_from_pairs, mol_table and fold_positions."""
    pairs = [(0, 1), (1, 2), (3, 4)]
    adj = TS.bonds_from_pairs(pairs, 6)
    assert adj == JS.bonds_from_pairs(pairs, 6)
    np.testing.assert_array_equal(TS.pad_bonds(adj, 6), np.asarray(JS.pad_bonds(adj, 6)))
    np.testing.assert_array_equal(TS.pad_bonds([[]] * 3, 3), np.asarray(JS.pad_bonds([[]] * 3, 3)))
    mol = np.array([0, 0, 0, 1, 1, 2])
    for a, b in zip(TS.mol_table(mol), JS.mol_table(mol)):
        np.testing.assert_array_equal(a, b)
    pos = np.array([[-0.5, 3.2], [7.9, -8.1]])
    st = TS.make_system(pos, [1, 2], 0.05, 1.0, molecule=[1, 1], bonds=[[1], [0]], device="cpu")
    js = JS.make_system(pos, [1, 2], 0.05, 1.0, molecule=[1, 1], bonds=[[1], [0]])
    np.testing.assert_array_equal(TS.fold_positions(st).position[0].numpy(),
                                  np.asarray(JS.fold_positions(js).position))
    assert st.molecule.tolist() == [[0, 0]] and st.is_molecular
    assert st.repeat(3).bonds.shape == (3, 2, 1)

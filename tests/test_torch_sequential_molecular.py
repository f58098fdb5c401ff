"""Molecular systems through the port's sequential kernel (moves/kernel.py):
tests/test_molecules.py's patterns on the port, one shared-draw
Displacement + MoleculeFlip sweep on a trimer melt against the JAX package,
the flip's refusals, and (slow) the trimer g(r) gate of the port's
sequential kernel against the port's checkerboard backend."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core import neighbours as JNB
from particlesmc_tpu.core.state import mol_table
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core import neighbours as TNB
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import kernel as TK

from .test_cb_molecular import _trimer_melt
from .test_torch_kernel import assert_same, batched_draws, port_mc_state, port_system, stack

torch.set_num_threads(1)


def jax_trimers(n_mol=8, seeds=(0,), density=0.4, temp=2.0, mixed=False):
    """JAX trimer melts (tests/test_cb_molecular.py), one per seed. With
    `mixed`, every odd molecule carries species (1, 1, 2), so that a third
    of its flip candidates fail."""
    states, table = [], None
    for s in seeds:
        st, table = _trimer_melt(n_mol=n_mol, density=density, temp=temp, seed=s)
        if mixed:
            sp = np.asarray(st.species).reshape(-1, 3).copy()
            sp[1::2] = [0, 0, 1]
            st = JE.initialize_energy(st.replace(species=jnp.asarray(sp.reshape(-1), st.species.dtype)), table)
        states.append(st)
    ms, ml = mol_table(np.asarray(states[0].molecule))
    return states, table, tuple(int(x) for x in ms), tuple(int(x) for x in ml)


def trimer_chains(n_mol=8, seeds=(0,), **kw):
    """The port's batched trimer melt, its table and molecule layout."""
    states, _, ms, ml = jax_trimers(n_mol, seeds, **kw)
    return port_system(stack(states)), TT.Trimer(device="cpu"), ms, ml


POOL = ((0.05, 0.5), 0.5)  # (sigma, p) of the displacement, p of the flip


def _pools():
    (sigma, p_d), p_f = POOL
    return ((JMB.displacement(sigma, p_d), JMB.molecule_flip(p_f)),
            (TMB.displacement(sigma, p_d), TMB.molecule_flip(p_f)))


def test_trimer_energy_and_bonded_terms():
    """The bonded sums matter: without bonds the total and one particle's
    energy change; the port's total equals the JAX package's."""
    states, jt, _, _ = jax_trimers()
    st = port_system(stack(states))
    table = TT.Trimer(device="cpu")
    e = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    assert torch.isfinite(e).all()
    np.testing.assert_allclose(e.numpy(), [float(s.energy) for s in states], rtol=1e-12)
    assert float(e[0]) != pytest.approx(float(TE.total_energy_dense(st.position, st.species, st.box, table)[0]))
    k = torch.tensor([[4]])
    full = TE.particle_energy_dense(k, st.position, st.species, st.box, table, st.bonds)
    assert float(full) != pytest.approx(float(TE.particle_energy_dense(k, st.position, st.species, st.box, table)))
    np.testing.assert_allclose(
        float(full), float(JE.particle_energy_dense(jnp.asarray(4), states[0].position, states[0].species,
                                                    states[0].box, jt, bonds=states[0].bonds)), rtol=1e-12)


def test_flip_move_invariants():
    """Four sweeps of Displacement + MoleculeFlip: the ledger equals a dense
    recompute with bonds, each molecule keeps its species multiset, and
    flips are attempted and accepted."""
    system, table, ms, ml = trimer_chains(seeds=(0, 1))
    pool = _pools()[1]
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=ms, mol_len=ml)
    mc = TK.init_mc_state(system, config, 5)
    assert mc.flip_rounds == 1  # every pair of a (1, 2, 3) trimer differs
    out = TK.build_run_fn(config, system.n_particles)(mc, TMB.init_pool_params(pool, device="cpu"), 4)
    st = out.system
    e = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    np.testing.assert_allclose(st.energy.numpy(), e.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(np.sort(st.species.numpy().reshape(2, -1, 3), axis=-1),
                                  np.broadcast_to([0, 1, 2], (2, 8, 3)))
    assert (out.attempted[:, 1] > 0).all() and (out.accepted[:, 1] > 0).all()
    TK.check_state(out)


@pytest.mark.parametrize("cells", [False, True], ids=["dense", "cells"])
def test_flip_sweep_matches_jax(cells):
    """One shared-draw Displacement + MoleculeFlip sweep on a trimer melt
    whose odd molecules are (1, 1, 2): JAX's rejection loop and the port's
    candidate rounds pick the same pairs."""
    n_mol, seeds = 8, (0, 1)
    states, jt, ms, ml = jax_trimers(n_mol, seeds, density=0.3, mixed=True)
    n = 3 * n_mol
    pool_j, pool_t = _pools()
    spec = JNB.make_spec(np.asarray(states[0].box), jt.max_cutoff, n) if cells else None
    assert (spec is not None) == cells
    config = JK.KernelConfig(pool=pool_j, table=jt, cell_spec=spec, mol_start=ms, mol_len=ml)
    keys = [jax.random.PRNGKey(s) for s in (21, 22)]
    mc_j0 = jax.vmap(lambda st, k: JK.init_mc_state(st, config, k))(stack(states), jnp.stack(keys))
    run = JK.build_run_fn(config, n)
    mc_j = jax.jit(jax.vmap(lambda m, p: run(m, p, 1), in_axes=(0, None)))(mc_j0, JMB.init_pool_params(pool_j))

    table = TT.Trimer(device="cpu")
    tspec = None if spec is None else TNB.CellSpec(spec.ncells, spec.cap)
    tconf = TK.KernelConfig(pool=pool_t, table=table, cell_spec=tspec, mol_start=ms, mol_len=ml)
    rounds = TK.flip_rounds(np.asarray(mc_j0.system.species), ms, ml)
    assert rounds == 16  # one round in six fails: (1/6)^16 < 1e-12
    _, draws = batched_draws(keys, pool_j, np.asarray(mc_j0.system.species), n, 3,
                             mol_start=ms, mol_len=ml, rounds=rounds)
    assert draws["flip"].shape == (2, n, rounds, 3)
    mc_t = TK.build_sweep_fn(tconf, n)(port_mc_state(mc_j0, rounds), TMB.init_pool_params(pool_t, device="cpu"),
                                       draws)
    assert_same(mc_j, mc_t, table, bonds=True)
    assert (mc_t.accepted[:, 1] > 0).all()
    TK.check_state(mc_t)


def test_flip_refusals():
    """Deliberate differences from the JAX package, whose flip loop redraws
    until the species differ: on molecules that each carry one species that
    loop never ends, and the port raises at init; a chain whose chosen flip
    finds no valid pair in its rounds rejects the step and the state check
    raises, while failed rounds on a step that chose another move are never
    looked at (only the chosen proposal decides)."""
    system, table, ms, ml = trimer_chains()
    pool = _pools()[1]
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=ms, mol_len=ml)
    with pytest.raises(ValueError, match="share one species"):
        TK.init_mc_state(system.replace(species=torch.zeros_like(system.species)), config, 0)
    with pytest.raises(ValueError, match="molecular"):
        TK.init_mc_state(system, TK.KernelConfig(pool=pool, table=table, cell_spec=None), 0)

    mc = TK.init_mc_state(system, config, 0)
    species = mc.system.species.clone()
    species[0, 6:9] = torch.tensor([2, 2, 1])  # molecule 2: sites 0 and 1 share species 2
    mc = mc.replace(system=mc.system.replace(species=species))
    step = TK.build_step_fn(config, system.n_particles)
    params = TMB.init_pool_params(pool, device="cpu")
    fail = torch.tensor([[[2, 0, 0]]])  # m 2, a 0, b 0 -> site 1: species 2 and 2
    good = torch.tensor([[[2, 0, 1]]])  # m 2, a 0, b 1 -> site 2: species 2 and 1
    base = {"i": torch.tensor([3]), "normal": torch.zeros((1, 3), dtype=torch.float64),
            "u": torch.tensor([0.5], dtype=torch.float64)}
    out, _ = step(mc, params, dict(base, move=torch.tensor([0]), flip=fail))
    assert not out.flip_failed.any()
    TK.check_state(out)
    out, acc = step(mc, params, dict(base, move=torch.tensor([1]), flip=fail))
    assert out.flip_failed.all() and not acc.any()
    assert torch.equal(out.system.species, mc.system.species)
    with pytest.raises(RuntimeError, match="MoleculeFlip"):
        TK.check_state(out)
    out, _ = step(mc, params, dict(base, move=torch.tensor([1]), flip=good))
    assert not out.flip_failed.any() and int(out.attempted[0, 1]) == 1


@pytest.mark.parametrize("per_step", [False, True], ids=["sweep_draws", "step_draws"])
def test_flip_rounds_at_high_fail_share(monkeypatch, per_step):
    """Nine molecules in ten carry one species, so a candidate round fails
    with probability 0.9: R = ceil(log 1e-12 / log 0.9) = 263 rounds, with
    no cap, keep a step's miss chance below 1e-12. Two sweeps, with the
    rounds drawn at the sweep's start or (past the per-sweep budget) per
    step, miss no valid pair, keep the ledger and the molecules' species
    multisets, and flip only the mixed molecule."""
    system, table, ms, ml = trimer_chains(n_mol=10, seeds=(0, 1))
    sp = torch.zeros((2, 10, 3), dtype=system.species.dtype)
    sp[:, 9] = torch.tensor([0, 1, 2])
    system = TE.initialize_energy(system.replace(species=sp.reshape(2, -1)), table)
    pool = _pools()[1]
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=ms, mol_len=ml)
    mc = TK.init_mc_state(system, config, 9)
    assert mc.flip_rounds == math.ceil(math.log(1e-12) / math.log(0.9)) == 263
    if per_step:
        monkeypatch.setattr(TK, "_FLIP_SWEEP_DRAWS", 0)
    out = TK.build_run_fn(config, system.n_particles)(mc, TMB.init_pool_params(pool, device="cpu"), 2)
    TK.check_state(out)
    assert (out.attempted[:, 1] > 0).all()
    st = out.system
    e = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    np.testing.assert_allclose(st.energy.numpy(), e.numpy(), rtol=1e-9, atol=1e-9)
    after = st.species.reshape(2, 10, 3)
    assert torch.equal(after[:, :9], sp[:, :9])
    assert torch.equal(torch.sort(after[:, 9], dim=-1).values, sp[:, 9])


@pytest.mark.slow
def test_molecular_gr_parity_sequential_vs_checkerboard():
    """The trimer g(r) gate (tests/test_cb_molecular.py's pattern) on the
    port: the pair-correlation function of a trimer melt agrees within MC
    error between the port's sequential kernel and its molecular
    checkerboard backend."""
    from particlesmc_tpu.analysis import radial_distribution
    from particlesmc_tpu_torch.moves import checkerboard as TCB

    system, table, ms, ml = trimer_chains(n_mol=64, seeds=(0,))
    n = system.n_particles
    pool = (TMB.displacement(0.12, 0.9), TMB.molecule_flip(0.1))
    params = TMB.init_pool_params(pool, device="cpu")
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=ms, mol_len=ml)
    sweep = TK.build_sweep_fn(config, n)
    mc = TK.init_mc_state(system, config, 13)
    for _ in range(200):
        mc = sweep(mc, params)
    box = mc.system.box[0].numpy()
    frames_seq = []
    for _ in range(150):
        mc = sweep(mc, params)
        frames_seq.append(mc.system.position[0].numpy())
    TK.check_state(mc)

    spec = TCB.make_cb_spec(box, TT.interaction_range(table), n, occ_factor=4.0)
    hs = TCB.build_hyper_sweep_fn(spec, table, n, pool=pool, max_bonds=int(system.bonds.shape[-1]))
    cb = TCB.init_cb_state(mc.system, spec, seed=11, n_moves=len(pool))
    frames_cb = []
    for _ in range(150):
        cb = hs(cb, params)
        frames_cb.append(cb.system.position[0].numpy())
    assert not cb.overflow.any()
    _, g_seq = radial_distribution(np.stack(frames_seq), box, nbins=40, rmax=3.0)
    _, g_cb = radial_distribution(np.stack(frames_cb), box, nbins=40, rmax=3.0)
    mask = (g_seq > 0.2) | (g_cb > 0.2)
    assert np.max(np.abs(g_seq[mask] - g_cb[mask])) < 0.35

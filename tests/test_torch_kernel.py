"""Parity of the port's sequential kernel (moves/kernel.py) with the JAX
package's, on the same draws.

The JAX package draws every step's randomness from key splits
(build_sweep_fn: one split per sweep and one key per step; build_step_fn:
k_move, k_prop, k_acc; each proposal from k_prop). `reference_draws`
rebuilds those numbers with the same jax.random calls and the port takes them
as `draws`, so both packages make the same moves. Tolerances: same counters
and species, positions within 1e-9, energy within rtol 1e-9, and the ledger
equal to a dense recompute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core import neighbours as JNB
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch import convert
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core import neighbours as TNB
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import kernel as TK

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Shared helpers (the molecular, tempering and card tests import them)
# ---------------------------------------------------------------------------


def lattice_states(n, d, density, temperature, model, seeds, n_species=2):
    """One JAX SystemState per seed: a jittered lattice with random species
    (tests/test_mc_kernel.py's start), energy initialised."""
    table = getattr(JT, model)()
    states = []
    for s in seeds:
        rng = np.random.default_rng(s)
        L = (n / density) ** (1 / d)
        per = int(np.ceil(n ** (1 / d)))
        a = L / per
        grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n]
        pos = grid + rng.uniform(-0.05 * a, 0.05 * a, (n, d))
        sp = rng.integers(1, n_species + 1, n)
        st = j_make_system(pos, sp, density, temperature)
        states.append(JE.initialize_energy(st, table, check=False))
    return states, table


def stack(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def port_system(st):
    """A batched JAX SystemState as the port's, on the CPU."""
    mol = None if st.molecule is None else np.asarray(st.molecule)
    bonds = None if st.bonds is None else np.asarray(st.bonds)
    return convert.system_from_numpy(
        np.asarray(st.position), np.asarray(st.species), np.asarray(st.box),
        np.asarray(st.density), np.asarray(st.temperature), np.asarray(st.energy),
        device="cpu", molecule=mol, bonds=bonds,
    )


def port_mc_state(mc, flip_rounds=0):
    """A batched JAX MCState as the port's (cell list included)."""
    cell = None
    if mc.cell is not None:
        cell = tuple(np.asarray(getattr(mc.cell, f)) for f in ("bucket", "count", "cell_of", "overflow"))
    return convert.mc_state_from_numpy(
        port_system(mc.system), np.asarray(mc.attempted), np.asarray(mc.accepted), cell,
        flip_rounds=flip_rounds,
    )


def reference_draws(key, pool, species, steps, d, mol_start=None, mol_len=None, rounds=0):
    """The draws the JAX package's sweep makes from one chain's key, as the
    port takes them, and the chain's key after the sweep. `species` [N]
    (the populations of a DoubleUniform swap; every move keeps them)."""
    dt = jnp.float64
    n = species.shape[0]
    probs = JMB.pool_probabilities(pool, dt)
    key, sub = jax.random.split(key)
    step_keys = jax.random.split(sub, steps)
    uniform_swaps = [(m, mv.species) for m, mv in enumerate(pool)
                     if mv.action == "swap" and mv.policy == "double_uniform"]
    ml = None if mol_len is None else jnp.asarray(mol_len, jnp.int32)

    def flip_round(k):
        ka, kb, kc = jax.random.split(k, 3)
        m = jax.random.randint(ka, (), 0, len(mol_start))
        L = ml[m]
        a = jax.random.randint(kb, (), 0, L)
        b = jax.random.randint(kc, (), 0, jnp.maximum(L - 1, 1))
        return jnp.stack([m, a, b]).astype(jnp.int64)

    def one(k):
        k_move, k_prop, k_acc = jax.random.split(k, 3)
        move = jax.random.choice(k_move, len(pool), p=probs)
        out = {"move": move, "u": jax.random.uniform(k_acc, (), dt, minval=jnp.finfo(dt).tiny)}
        actions = {mv.action for mv in pool}
        k1, k2 = jax.random.split(k_prop)
        if "displacement" in actions:
            out["i"] = jax.random.randint(k1, (), 0, n, dtype=jnp.int32)
            out["normal"] = jax.random.normal(k2, (d,), dt)
        if uniform_swaps:
            r1 = r2 = jnp.asarray(0, jnp.int64)
            for m, (s1, s2) in uniform_swaps:
                n1 = jnp.sum(species == s1)
                n2 = jnp.sum(species == s2)
                r1 = jnp.where(move == m, jax.random.randint(k1, (), 0, jnp.maximum(n1, 1)), r1)
                r2 = jnp.where(move == m, jax.random.randint(k2, (), 0, jnp.maximum(n2, 1)), r2)
            out["r1"], out["r2"] = r1, r2
        if any(mv.policy == "energy_bias" for mv in pool):
            out["gumbel"] = jnp.stack([jax.random.gumbel(k1, (n,), dt), jax.random.gumbel(k2, (n,), dt)])
        if "flip" in actions:
            kk, s = jax.random.split(k_prop)
            rows = [flip_round(s)]
            for _ in range(rounds - 1):
                kk, s = jax.random.split(kk)
                rows.append(flip_round(s))
            out["flip"] = jnp.stack(rows)
        return out

    draws = jax.jit(jax.vmap(one))(step_keys)
    return key, {k: np.asarray(v) for k, v in draws.items()}


def batched_draws(keys, pool, species, steps, d, **kw):
    """reference_draws of every chain as port tensors [B, S, ...], and the
    chains' keys after the sweep."""
    per = [reference_draws(k, pool, np.asarray(species[b]), steps, d, **kw) for b, k in enumerate(keys)]
    draws = {k: torch.tensor(np.stack([p[1][k] for p in per])) for k in per[0][1]}
    for k in ("move", "i", "r1", "r2", "flip"):
        if k in draws:
            draws[k] = draws[k].long()
    return [p[0] for p in per], draws


def pools(kind):
    """(JAX pool, port pool) of one kind."""
    def both(name, *a, **kw):
        return getattr(JMB, name)(*a, **kw), getattr(TMB, name)(*a, **kw)

    moves = {
        "displacement": [both("displacement", 0.1)],
        "uniform": [both("displacement", 0.1, 0.5), both("discrete_swap", 0, 1, 0.5)],
        "energy_bias": [both("displacement", 0.1, 0.6),
                        both("discrete_swap", 0, 1, 0.4, policy="energy_bias", theta1=0.7, theta2=-0.4)],
    }[kind]
    return tuple(m[0] for m in moves), tuple(m[1] for m in moves)


def assert_same(mc_j, mc_t, table, bonds=False):
    """Same counters and species, positions within 1e-9, energy within
    rtol 1e-9, and the ledger equal to a dense recompute."""
    np.testing.assert_array_equal(mc_t.attempted.numpy(), np.asarray(mc_j.attempted))
    np.testing.assert_array_equal(mc_t.accepted.numpy(), np.asarray(mc_j.accepted))
    np.testing.assert_array_equal(mc_t.system.species.numpy(), np.asarray(mc_j.system.species))
    np.testing.assert_allclose(mc_t.system.position.numpy(), np.asarray(mc_j.system.position), rtol=0, atol=1e-9)
    np.testing.assert_allclose(mc_t.system.energy.numpy(), np.asarray(mc_j.system.energy), rtol=1e-9)
    st = mc_t.system
    e = TE.total_energy_dense(st.position, st.species, st.box, table, st.bonds if bonds else None)
    np.testing.assert_allclose(st.energy.numpy(), e.numpy(), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------

# tests/test_mc_kernel.py's parity state; a third of a sweep keeps the CPU
# time of the EnergyBias cases (two energy passes per step) small
N3, STEPS, SEEDS = 216, 72, (11, 12)


def _parity(kind, cells, sweeps=1):
    states, jt = lattice_states(N3, 3, 0.5, 2.0, "KobAndersen", seeds=(4, 5))
    pool_j, pool_t = pools(kind)
    spec = JNB.make_spec(np.asarray(states[0].box), jt.max_cutoff, N3) if cells else None
    assert (spec is not None) == cells
    config = JK.KernelConfig(pool=pool_j, table=jt, cell_spec=spec, sweepstep=STEPS)
    batch = stack(states)
    keys = [jax.random.PRNGKey(s) for s in SEEDS]
    mc_j0 = jax.vmap(lambda st, k: JK.init_mc_state(st, config, k))(batch, jnp.stack(keys))
    run = JK.build_run_fn(config, N3)
    mc_j = jax.jit(jax.vmap(lambda m, p: run(m, p, sweeps), in_axes=(0, None)))(
        mc_j0, JMB.init_pool_params(pool_j)
    )

    table = TT.KobAndersen(device="cpu")
    tspec = None if spec is None else TNB.CellSpec(spec.ncells, spec.cap)
    tconf = TK.KernelConfig(pool=pool_t, table=table, cell_spec=tspec, sweepstep=STEPS)
    mc_t = port_mc_state(mc_j0)
    sweep = TK.build_sweep_fn(tconf, N3)
    params = TMB.init_pool_params(pool_t, device="cpu")
    for _ in range(sweeps):
        keys, draws = batched_draws(keys, pool_j, np.asarray(batch.species), STEPS, 3)
        mc_t = sweep(mc_t, params, draws)
    return mc_j, mc_t, mc_j0, table


@pytest.mark.parametrize("cells", [False, True], ids=["dense", "cells"])
@pytest.mark.parametrize("kind", ["displacement", "uniform", "energy_bias"])
def test_sweep_matches_jax(kind, cells):
    """One JAX build_run_fn call against the port's sweep on the JAX draws,
    3D KA N = 216, dense and with a cell list."""
    mc_j, mc_t, mc_j0, table = _parity(kind, cells)
    assert_same(mc_j, mc_t, table)
    acc = mc_t.accepted.numpy()
    assert (acc > 0).all(), acc
    assert (mc_t.attempted.numpy().sum(axis=1) == STEPS).all()
    np.testing.assert_array_equal(
        np.sort(mc_t.system.species.numpy(), axis=1), np.sort(np.asarray(mc_j0.system.species), axis=1)
    )
    if cells:
        for f in ("bucket", "count", "cell_of", "overflow"):
            np.testing.assert_array_equal(getattr(mc_t.cell, f).numpy(), np.asarray(getattr(mc_j.cell, f)))
        assert not mc_t.cell.overflow.any()


def test_categorical_is_gumbel_argmax():
    """The draws' EnergyBias picks rest on jax.random.categorical being the
    argmax of logits plus Gumbel noise of the same key: check it on the
    installed JAX, with masked (-inf) logits."""
    rng = np.random.default_rng(0)
    for s in range(20):
        key = jax.random.PRNGKey(s)
        logits = jnp.asarray(np.where(rng.random(50) < 0.3, -np.inf, rng.normal(0, 3, 50)))
        g = jax.random.gumbel(key, logits.shape, logits.dtype)
        assert int(jax.random.categorical(key, logits)) == int(jnp.argmax(logits + g))


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------


def _port_chains(n, d, density, temperature, model, seeds, n_species=2):
    states, _ = lattice_states(n, d, density, temperature, model, seeds, n_species)
    return port_system(stack(states)), getattr(TT, model)(device="cpu")


def _config(pool, table, system, cells, sweepstep=None, cap=None):
    spec = TNB.make_spec(system.box[0].numpy(), table.max_cutoff, system.n_particles, cap) if cells else None
    assert (spec is not None) == cells
    return TK.KernelConfig(pool=pool, table=table, cell_spec=spec, sweepstep=sweepstep)


def test_dense_vs_cell_trajectory_parity():
    """The same generator seed gives the same trajectory with the dense ΔE
    and with the cell list (the reference's own gate), over two sweeps of a
    displacement + swap pool; the incremental cell list equals a rebuild."""
    system, table = _port_chains(N3, 3, 0.5, 2.0, "KobAndersen", seeds=(4, 5))
    pool = (TMB.displacement(0.1, 0.5), TMB.discrete_swap(0, 1, 0.5))
    params = TMB.init_pool_params(pool, device="cpu")
    out = {}
    for cells in (False, True):
        config = _config(pool, table, system, cells)
        run = TK.build_run_fn(config, N3)
        out[cells] = run(TK.init_mc_state(system, config, 11), params, 2)
    a, b = out[False], out[True]
    np.testing.assert_allclose(a.system.position.numpy(), b.system.position.numpy(), rtol=0, atol=1e-9)
    assert torch.equal(a.system.species, b.system.species)
    assert torch.equal(a.accepted, b.accepted) and torch.equal(a.attempted, b.attempted)
    np.testing.assert_allclose(a.system.energy.numpy(), b.system.energy.numpy(), rtol=1e-9)
    assert (a.accepted > 0).all() and not b.cell.overflow.any()
    fresh = TNB.build_cell_list(b.system.position, b.system.box, config.cell_spec)
    assert torch.equal(fresh.count, b.cell.count) and torch.equal(fresh.cell_of, b.cell.cell_of)
    TK.check_state(b)


def test_batched_chains_match_solo_runs():
    """A batch of two chains on their draws evolves as each chain alone on
    its own draws; different draws give different trajectories."""
    system, table = _port_chains(64, 2, 0.6, 1.5, "BHHP", seeds=(1, 2))
    pool = (TMB.displacement(0.1, 0.7), TMB.discrete_swap(0, 1, 0.3))
    params = TMB.init_pool_params(pool, device="cpu")
    config = _config(pool, table, system, False)
    sweep = TK.build_sweep_fn(config, 64)
    mc = TK.init_mc_state(system, config, 0)
    gen = torch.Generator().manual_seed(5)
    draws = {
        "move": (torch.rand((2, 64), generator=gen) < 0.3).long(),
        "i": torch.randint(0, 64, (2, 64), generator=gen),
        "normal": torch.randn((2, 64, 2), generator=gen, dtype=torch.float64),
        "r1": torch.randint(0, 10, (2, 64), generator=gen),
        "r2": torch.randint(0, 10, (2, 64), generator=gen),
        "u": torch.rand((2, 64), generator=gen, dtype=torch.float64),
    }
    both = sweep(mc, params, draws)
    for b in range(2):
        one = TK.init_mc_state(_take_chain(system, b), config, 0)
        solo = sweep(one, params, {k: v[b:b + 1] for k, v in draws.items()})
        np.testing.assert_allclose(solo.system.position[0].numpy(), both.system.position[b].numpy(), rtol=0, atol=1e-12)
        assert torch.equal(solo.system.species[0], both.system.species[b])
        assert torch.equal(solo.accepted[0], both.accepted[b])
    assert not torch.allclose(both.system.position[0], both.system.position[1])


def _take_chain(system, b):
    return system.replace(**{
        f: getattr(system, f)[b:b + 1] for f in ("position", "species", "box", "temperature", "density", "energy")
    })


def test_inf_guard_rejects_overlap_and_keeps_ledger():
    """A displacement that stretches a FENE bond past r0 has an infinite
    energy: the step rejects it and books nothing (build_step_fn)."""
    from .test_torch_sequential_molecular import trimer_chains

    system, table, ms, ml = trimer_chains(n_mol=8, seeds=(0,))
    pool = (TMB.displacement(0.1),)
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=ms, mol_len=ml)
    step = TK.build_step_fn(config, system.n_particles)
    mc = TK.init_mc_state(system, config, 0)
    params = TMB.init_pool_params(pool, device="cpu")
    far = {"move": torch.tensor([0]), "i": torch.tensor([4]), "u": torch.tensor([1e-300], dtype=torch.float64),
           "normal": torch.tensor([[30.0, 0.0, 0.0]], dtype=torch.float64)}
    out, accept = step(mc, params, far)
    assert not accept.any()
    assert torch.equal(out.system.position, mc.system.position)
    assert torch.equal(out.system.energy, mc.system.energy)
    assert out.attempted.tolist() == [[1]] and out.accepted.tolist() == [[0]]
    near = dict(far, normal=torch.tensor([[1e-3, 0.0, 0.0]], dtype=torch.float64))
    out, accept = step(mc, params, near)
    assert accept.all() and float(out.system.energy[0]) != float(mc.system.energy[0])


def test_empty_population_swap_is_rejected():
    """A swap into an empty species population never moves: every step
    rejects, for DoubleUniform and for EnergyBias."""
    system, table = _port_chains(64, 2, 0.6, 1.5, "BHHP", seeds=(3,), n_species=1)
    assert (system.species == 0).all()
    for swap in (TMB.discrete_swap(0, 1, 0.5), TMB.discrete_swap(1, 0, 0.5, policy="energy_bias", theta1=0.3)):
        pool = (TMB.displacement(0.1, 0.5), swap)
        config = _config(pool, table, system, False)
        out = TK.build_run_fn(config, 64)(TK.init_mc_state(system, config, 2), TMB.init_pool_params(pool, device="cpu"), 2)
        assert int(out.attempted[0, 1]) > 0 and int(out.accepted[0, 1]) == 0
        assert (out.system.species == 0).all() and int(out.accepted[0, 0]) > 0
        e = TE.total_energy_dense(out.system.position, out.system.species, out.system.box, table)
        np.testing.assert_allclose(out.system.energy.numpy(), e.numpy(), rtol=1e-9)


def test_mixed_precision_ledger_and_draw_checks():
    """f32 positions with an f64 ledger: ΔE widens into the ledger, which
    stays f64 and within 1e-5 per particle of an f64 recompute. Fed-in
    draws must have the pool's keys and the sweep's length."""
    system, table = _port_chains(64, 2, 0.6, 1.5, "BHHP", seeds=(6, 7))
    system = system.replace(position=system.position.float(), box=system.box.float(),
                            temperature=system.temperature.float(), density=system.density.float())
    pool = (TMB.displacement(0.1),)
    config = _config(pool, table.astype(torch.float32), system, False)
    sweep = TK.build_sweep_fn(config, 64)
    mc = TK.init_mc_state(system, config, 3)
    out = TK.build_run_fn(config, 64)(mc, TMB.init_pool_params(pool, torch.float32, "cpu"), 3)
    assert out.system.energy.dtype == torch.float64 and out.system.position.dtype == torch.float32
    e = TE.total_energy_dense(out.system.position.double(), out.system.species, out.system.box.double(), table)
    assert float((out.system.energy - e).abs().max()) / 64 < 1e-5
    z = torch.zeros((2, 64), dtype=torch.long)
    with pytest.raises(ValueError, match="takes draws"):
        sweep(mc, TMB.init_pool_params(pool, torch.float32, "cpu"), {"move": z, "u": z.float()})
    with pytest.raises(ValueError, match="steps"):
        sweep(mc, TMB.init_pool_params(pool, torch.float32, "cpu"),
              {"move": z[:, :5], "u": z[:, :5].float(), "i": z[:, :5], "normal": torch.zeros((2, 5, 2))})

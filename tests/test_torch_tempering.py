"""The port's replica exchange and adaptive sigma (engine/tempering.py,
engine/adaptive.py) against the JAX package's: the same acceptance uniforms
give the same attempted/accepted pairs and the same permuted states, on the
sequential kernel's MCState and on the checkerboard's CBState; and the
engine patterns of tests/test_simulation.py and tests/test_tempering.py on
the port, on both backends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.engine.tempering import replica_exchange as j_replica_exchange
from particlesmc_tpu.io import formats as JF
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch.core.energy import total_energy_dense
from particlesmc_tpu_torch.engine.schedule import build_schedule
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.engine.tempering import replica_exchange
from particlesmc_tpu_torch.io.loader import Chains, load_chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .test_torch_checkerboard import port_cb_state
from .test_torch_checkerboard import port_system as cb_port_system
from .test_torch_kernel import lattice_states, port_mc_state, port_system, stack

torch.set_num_threads(1)

M = 8


def _ladder(m=M, n=32):
    """M chains of a small KA system on the ladder 0.5 .. 2.0 (JAX states)."""
    states, jt = lattice_states(n, 2, 0.5, 1.0, "KobAndersen", seeds=range(m))
    batch = stack(states).replace(temperature=jnp.linspace(0.5, 2.0, m))
    return batch, jt


def _u(key, m=M):
    return jax.random.uniform(key, (m,), jnp.float64, minval=jnp.finfo(jnp.float64).tiny)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_exchanges_configurations_not_temperatures(parity):
    """On the same u, the port's pass attempts and accepts JAX's pairs and
    moves the same configurations (cell list included); temperatures and
    counters stay with their slots; the energy multiset is kept."""
    batch, jt = _ladder()
    # energies spread so that some pairs accept and some reject
    batch = batch.replace(energy=batch.energy + jnp.asarray([0.0, 3.0, -2.0, 1.0, 5.0, -4.0, 0.5, 0.2]))
    spec = JK.NB.make_spec(np.asarray(batch.box[0]), jt.max_cutoff, 32)
    config = JK.KernelConfig(pool=(JMB.displacement(0.1),), table=jt, cell_spec=spec)
    mc = jax.vmap(lambda s, k: JK.init_mc_state(s, config, k))(batch, jax.random.split(jax.random.PRNGKey(0), M))
    mc = mc.replace(attempted=jnp.arange(M)[:, None], accepted=jnp.arange(M)[:, None] // 2)
    key = jax.random.PRNGKey(42 + parity)
    mc_j, att_j, acc_j = j_replica_exchange(mc, key, parity)
    mc_t0 = port_mc_state(mc)
    mc_t, att, acc = replica_exchange(mc_t0, parity, u=torch.tensor(np.asarray(_u(key))))
    np.testing.assert_array_equal(att.numpy(), np.asarray(att_j))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert att.numpy().tolist() == ([True, False] * 4 if parity == 0 else [False, True] * 3 + [False, False])
    assert int(acc.sum()) > 0
    if parity == 0:  # some pairs accept and some reject
        assert int(acc.sum()) < int(att.sum())
    ref = port_mc_state(mc_j)
    for f in ("position", "species", "energy", "box", "temperature", "density"):
        assert torch.equal(getattr(mc_t.system, f), getattr(ref.system, f)), f
    for f in ("bucket", "count", "cell_of", "overflow"):
        assert torch.equal(getattr(mc_t.cell, f), getattr(ref.cell, f)), f
    assert torch.equal(mc_t.attempted, mc_t0.attempted) and torch.equal(mc_t.accepted, mc_t0.accepted)
    assert torch.equal(mc_t.system.temperature, mc_t0.system.temperature)
    assert mc_t.generator is mc_t0.generator
    np.testing.assert_array_equal(np.sort(mc_t.system.energy.numpy()), np.sort(mc_t0.system.energy.numpy()))


def test_swap_acceptance_rule():
    """E_0 > E_1 with β_0 > β_1 gives log α > 0: the pair always swaps."""
    batch, jt = _ladder(m=2)
    mc = port_mc_state(jax.vmap(lambda s, k: JK.init_mc_state(s, JK.KernelConfig(
        pool=(JMB.displacement(0.1),), table=jt, cell_spec=None), k))(batch, jax.random.split(jax.random.PRNGKey(0), 2)))
    mc = mc.replace(system=mc.system.replace(
        energy=torch.tensor([10.0, -10.0], dtype=torch.float64), temperature=torch.tensor([0.5, 2.0], dtype=torch.float64)))
    out, att, acc = replica_exchange(mc, 0, u=torch.tensor([1 - 1e-16, 0.5], dtype=torch.float64))
    assert bool(acc[0]) and att.tolist() == [True, False]
    np.testing.assert_allclose(out.system.energy.numpy(), [-10.0, 10.0])
    np.testing.assert_allclose(out.system.temperature.numpy(), [0.5, 2.0])


def test_checkerboard_state_exchange_matches_jax():
    """On a CBState the planes, bins, slots, shift and skip counters travel
    with the configuration, as in the JAX package; counters stay."""
    n, seeds = 122, list(range(4))
    from .test_torch_checkerboard import jax_chains

    states, jt = jax_chains(n, 2, seeds, density=1.0)
    states = [s.replace(temperature=jnp.asarray(t)) for s, t in zip(states, (0.6, 0.8, 1.0, 1.2))]
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, n)
    cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=1) for st, s in zip(states, seeds)]
    cb_j = jax.tree.map(lambda *x: jnp.stack(x), *cbs)
    cb_j = cb_j.replace(shift=jnp.arange(8.0).reshape(4, 2), skipped=jnp.arange(4),
                        system=cb_j.system.replace(energy=jnp.asarray([-40.0, -80.0, -90.0, -50.0])))
    key = jax.random.PRNGKey(7)
    out_j, att_j, acc_j = j_replica_exchange(cb_j, key, 0)
    st0 = cb_port_system(cbs_to_states(cb_j))
    cb_t = port_cb_state(st0, [jax.tree.map(lambda x: x[k], cb_j) for k in range(4)])
    out_t, att, acc = replica_exchange(cb_t, 0, u=torch.tensor(np.asarray(_u(key, 4))))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert int(acc.sum()) > 0
    for f in ("planes", "idx", "slot", "shift", "overflow", "skipped", "attempted", "accepted"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), err_msg=f)
    np.testing.assert_array_equal(out_t.system.energy.numpy(), np.asarray(out_j.system.energy))
    np.testing.assert_array_equal(out_t.system.temperature.numpy(), [0.6, 0.8, 1.0, 1.2])


def cbs_to_states(cb):
    return [jax.tree.map(lambda x: x[k], cb.system) for k in range(cb.system.energy.shape[0])]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _write_small_config(path, n=48, d=2, density=0.5, T_=1.5, seed=0):
    """tests/test_simulation.py's start: a jittered lattice of KA species."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per = int(np.ceil(n ** (1 / d)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n]
    pos = grid + rng.uniform(-0.05 * a, 0.05 * a, (n, d))
    with open(path, "w") as f:
        f.write(JF.write_xyz_frame(rng.integers(1, 3, n), pos, np.full(d, L), 0, density, T_))


def test_adaptive_sigma_targets_acceptance(tmp_path):
    """AdaptiveSigma drives sigma from a hopeless 1.0 at a dense state point
    toward the target acceptance on the sequential kernel, then writes the
    tuned sigma into the live pool parameters."""
    cfg = tmp_path / "config.xyz"
    _write_small_config(str(cfg), n=48, density=0.9, T_=1.0)
    chains = load_chains(str(cfg), args={"temperature": 1.5, "model": "KobAndersen", "list_type": "EmptyList",
                                         "nsim": 8}, device="cpu")
    steps = 120
    sim = Simulation(chains, [
        dict(algorithm="Metropolis", pool=(TMB.displacement(1.0),), seed=3, sweepstep=chains.n_particles),
        dict(algorithm="AdaptiveSigma", scheduler=build_schedule(steps, 0, 5), target=0.4, kappa=1.5),
    ], steps, path=str(tmp_path / "out"))
    sim.run()
    log = np.loadtxt(tmp_path / "out" / "moves" / "1" / "sigma.dat")
    assert log.shape[0] > 10
    final_sigma, final_rate = log[-1, 1], log[-1, 2]
    assert final_sigma < 0.5
    assert abs(final_rate - 0.4) < 0.15
    assert float(sim.pool_params[0]["sigma"]) == pytest.approx(final_sigma, rel=1e-10)
    assert sim.pool_params[0]["sigma"].dtype == torch.float64


def test_temperature_ladder_from_one_config(tmp_path):
    """A temperature vector with one configuration replicates the frame on
    every rung, composing with nsim; a vector of the wrong length raises."""
    cfg = tmp_path / "config.xyz"
    _write_small_config(str(cfg))
    ladder = [2.0, 1.5, 1.0, 0.8]
    args = {"temperature": ladder, "model": "KobAndersen", "list_type": "EmptyList"}
    chains = load_chains(str(cfg), args=args, device="cpu")
    assert chains.n_chains == 4
    np.testing.assert_allclose(chains.states.temperature.numpy(), ladder)
    p = chains.states.position.numpy()
    np.testing.assert_array_equal(p[0], p[3])
    chains2 = load_chains(str(cfg), args=dict(args, nsim=2), device="cpu")
    assert chains2.n_chains == 8
    np.testing.assert_allclose(chains2.states.temperature.numpy(), [t for t in ladder for _ in range(2)])
    multi = tmp_path / "multi"
    multi.mkdir()
    _write_small_config(str(multi / "a.xyz"))
    _write_small_config(str(multi / "b.xyz"), seed=1)
    with pytest.raises(ValueError, match="temperature vector length"):
        load_chains(str(multi), args=dict(args, temperature=[1.0, 2.0, 3.0]), device="cpu")


@pytest.mark.parametrize("parallel_moves", [False, True], ids=["sequential", "checkerboard"])
def test_replica_exchange_in_simulation(tmp_path, parallel_moves):
    """ReplicaExchange on either backend: tempering_acceptance.dat is
    written, swaps happen, temperatures stay with their slots, and every
    chain's ledger equals a dense recompute."""
    ladder = [0.7, 0.9, 1.2, 1.6]
    states, jt = lattice_states(140 if parallel_moves else 48, 2, 1.19 if parallel_moves else 0.6, 1.0, "JBB",
                                seeds=range(4), n_species=3)
    st = port_system(stack(states)).replace(temperature=torch.tensor(ladder, dtype=torch.float64))
    chains = Chains(states=st, table=TT.JBB(device="cpu"), list_type="dense",
                    list_parameters={"inner": 2}, n_chains=4)
    steps = 12
    sim = Simulation(chains, [
        dict(algorithm="Metropolis", pool=(TMB.displacement(0.1),), seed=5, parallel_moves=parallel_moves,
             sweepstep=48),
        dict(algorithm="ReplicaExchange", scheduler=build_schedule(steps, 0, 1)),
    ], steps, path=str(tmp_path))
    sim.run()
    acc = np.loadtxt(tmp_path / "tempering_acceptance.dat", ndmin=2)
    assert acc.shape == (steps, 2) and acc[-1, 1] > 0
    np.testing.assert_array_equal(sim.mc.system.temperature.numpy(), ladder)
    assert sim._rex.accepted > 0
    s = sim.mc.system
    e = total_energy_dense(s.position, s.species, s.box, chains.table)
    np.testing.assert_allclose(s.energy.numpy(), e.numpy(), rtol=1e-9, atol=1e-9)
    if parallel_moves:
        assert isinstance(sim.mc, TCB.CBState)


def test_adaptive_sigma_on_checkerboard(tmp_path):
    """AdaptiveSigma on the checkerboard backend: sigma stays below half the
    smallest cell side (the default sigma_max), shrinks from a too-large
    start, and the hyper-sweep reads the updated value."""
    states, _ = lattice_states(140, 2, 1.19, 1.0, "JBB", seeds=range(2), n_species=3)
    chains = Chains(states=port_system(stack(states)), table=TT.JBB(device="cpu"), list_type="dense",
                    list_parameters={"inner": 2}, n_chains=2)
    steps = 12
    sim = Simulation(chains, [
        dict(algorithm="Metropolis", pool=(TMB.displacement(0.5),), seed=2, parallel_moves=True),
        dict(algorithm="AdaptiveSigma", scheduler=build_schedule(steps, 0, 2), target=0.4),
    ], steps, path=str(tmp_path))
    side = float(chains.states.box[0, 0]) / sim.cb_spec.ncells[0]
    assert sim._sigma_tuner.sigma_max == pytest.approx(side / 2)
    sim.run()
    log = np.loadtxt(tmp_path / "moves" / "1" / "sigma.dat", ndmin=2)
    assert log.shape == (steps // 2 - 1, 3)
    assert (log[:, 1] <= side / 2 + 1e-12).all() and log[-1, 1] < 0.5
    assert float(sim.pool_params[0]["sigma"]) == pytest.approx(log[-1, 1], rel=1e-10)
    s = sim.mc.system
    e = total_energy_dense(s.position, s.species, s.box, chains.table)
    np.testing.assert_allclose(s.energy.numpy(), e.numpy(), rtol=1e-9)

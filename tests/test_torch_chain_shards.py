"""The engine's chain sharding (parallel/mesh.py shard_chains/gather_chains,
Simulation(devices=...)) on CPU shards: the sharded run against the
unsharded one, bitwise where the CPU's per-chain arithmetic does not depend
on the batch size (positions, ledgers, counters and the output files), and
the sharded sweep plus replica exchange against the JAX package's run over
its 8 virtual CPU devices."""

import os
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from particlesmc_tpu.engine.tempering import replica_exchange as j_replica_exchange
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch.core.energy import initialize_energy
from particlesmc_tpu_torch.core.state import ChainBlock, make_system
from particlesmc_tpu_torch.engine import pgmc as TP
from particlesmc_tpu_torch.engine import tempering as TTM
from particlesmc_tpu_torch.engine.schedule import build_schedule
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB
from particlesmc_tpu_torch.moves import kernel as TK
from particlesmc_tpu_torch.parallel import mesh as PM

from .test_tempering import _ladder_batch
from .test_torch_kernel import batched_draws, port_mc_state
from .test_torch_tempering import _u

torch.set_num_threads(1)

LADDER = [0.7, 0.9, 1.2, 1.6]
# backend: (parallel_moves, list_type, list_parameters, N, density)
BACKENDS = {
    "checkerboard": (True, "dense", {"inner": 2}, 140, 1.19),
    "dense": (False, "dense", {}, 48, 0.6),
    "cells": (False, "cell", {"force_cells": True}, 100, 0.5),
}


def _chains(backend, n_chains=4, temperatures=LADDER, seed=0):
    """KA 2D chains of one jittered lattice each, f64 on the CPU."""
    parallel, list_type, lp, n, rho = BACKENDS[backend]
    rng = np.random.default_rng(seed)
    L = (n / rho) ** 0.5
    per = int(np.ceil(n ** 0.5))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * 2, indexing="ij"), -1).reshape(-1, 2)[:n]
    pos = np.stack([grid + rng.uniform(-0.05 * a, 0.05 * a, (n, 2)) for _ in range(n_chains)])
    table = TT.KobAndersen(device="cpu")
    st = make_system(pos, rng.integers(1, 3, (n_chains, n)), rho, temperatures, device="cpu")
    return Chains(states=initialize_energy(st, table), table=table, list_type=list_type,
                  list_parameters=dict(lp), n_chains=n_chains)


def _metropolis(backend, pool=None, seed=5):
    return dict(algorithm="Metropolis", pool=pool or (TMB.displacement(0.1),), seed=seed,
                parallel_moves=BACKENDS[backend][0], sweepstep=48)


def _files(root):
    """Every output file under `root` but the log (whose Device line names
    the shards), as bytes."""
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            if f != "simulation.log":
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _assert_same_state(a, b):
    """Bitwise positions, species, ledgers and counters."""
    for f in ("position", "species", "energy", "temperature"):
        assert torch.equal(getattr(a.system, f), getattr(b.system, f)), f
    assert torch.equal(a.attempted, b.attempted) and torch.equal(a.accepted, b.accepted)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_shard_chains_gives_each_block_its_generator():
    """Contiguous blocks in chain order, each a copy with its ChainBlock and
    a generator of its own in the parent's state; gather_chains is the
    inverse and refuses generators out of step; a generator cannot cross
    device types."""
    chains = _chains("checkerboard", n_chains=4)
    spec = TCB.make_cb_spec(chains.states.box[0].numpy(), chains.table.max_cutoff, chains.n_particles)
    cb = TCB.init_cb_state(chains.states, spec, seed=3)
    mesh = PM.make_mesh(device=["cpu"] * 2)
    blocks = PM.shard_chains(cb, mesh)
    assert [b.chains for b in blocks] == [ChainBlock(0, 2, 4), ChainBlock(2, 4, 4)]
    gens = [cb.generator] + [b.generator for b in blocks]
    assert len({id(g) for g in gens}) == 3
    assert all(torch.equal(g.get_state(), cb.generator.get_state()) for g in gens)
    assert torch.equal(blocks[1].system.position, cb.system.position[2:])
    assert blocks[0].planes.data_ptr() != cb.planes.data_ptr()
    back = PM.gather_chains(blocks, mesh)
    assert back.chains is None and back.generator not in gens
    for f in ("planes", "idx", "slot", "shift", "attempted"):
        assert torch.equal(getattr(back, f), getattr(cb, f)), f
    _assert_same_state(back, cb)
    with pytest.raises(ValueError, match="already a shard"):
        PM.shard_chains(blocks[0], mesh)
    with pytest.raises(ValueError, match="do not split evenly"):
        PM.shard_chains(cb, PM.make_mesh(3, "cpu"))
    torch.rand(3, generator=blocks[1].generator)  # a draw on one shard only
    with pytest.raises(RuntimeError, match="out of step"):
        PM.gather_chains(blocks, mesh)
    with pytest.raises(ValueError, match="cannot draw"):
        PM.copy_generator(cb.generator, "cuda")
    with pytest.raises(ValueError, match="not visible"):
        PM.make_mesh(device=["cpu", f"cuda:{torch.cuda.device_count()}"])


def _outputs(steps):
    every = build_schedule(steps, 0, 1)
    return [
        dict(algorithm="ReplicaExchange", scheduler=every),
        dict(algorithm="AdaptiveSigma", scheduler=build_schedule(steps, 0, 2), target=0.4),
        dict(algorithm="StoreCallbacks", callbacks=("energy", "acceptance"), scheduler=every),
        dict(algorithm="StoreAcceptance", scheduler=every),
        dict(algorithm="StoreParameters", scheduler=every),
        dict(algorithm="StoreTrajectories", scheduler=build_schedule(steps, 0, 2)),
        dict(algorithm="StoreLastFrames", scheduler=[steps]),
        dict(algorithm="StoreCheckpoints", scheduler=[steps]),
    ]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_engine_shards_match_unsharded(tmp_path, monkeypatch, backend, P):
    """A 4-rung ladder with ReplicaExchange every step and AdaptiveSigma,
    as P CPU shards and unsharded: the same final state bitwise and the
    same bytes in every output file (checkpoint included); some swap
    crosses a shard boundary."""
    steps = 6
    swaps = []
    exchange = TTM.replica_exchange

    def recording(mc, parity, u=None, generator=None):
        out, att, acc = exchange(mc, parity, u, generator)
        swaps.append(acc.clone())
        return out, att, acc

    monkeypatch.setattr(TTM, "replica_exchange", recording)
    runs = {}
    for name, devices in (("ref", None), ("sharded", ["cpu"] * P)):
        sim = Simulation(_chains(backend), [_metropolis(backend)] + _outputs(steps), steps,
                         path=str(tmp_path / name), devices=devices)
        assert (sim.mesh is None) == (devices is None)
        sim.run()
        runs[name] = sim
    ref, sh = runs["ref"], runs["sharded"]
    assert len(sh.shards) == P and [s.chains.lo for s in sh.shards] == list(range(0, 4, 4 // P))
    _assert_same_state(ref.mc, sh.mc)
    assert ref.mc.attempted.sum() > 0 and ref._rex.accepted > 0
    assert sh._rex.accepted == ref._rex.accepted and sh._rex.attempted == ref._rex.attempted
    assert float(sh.pool_params[0]["sigma"]) == float(ref.pool_params[0]["sigma"]) != 0.1
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "sharded")
    assert sorted(a) == sorted(b) and len(a) >= 4 * 4 + 3
    for f in a:
        assert a[f] == b[f], f
    crossing = [k for acc in swaps[steps:] for k in np.flatnonzero(acc.numpy()) if (k + 1) % (4 // P) == 0]
    assert crossing, "no swap crossed a shard boundary"
    log = open(tmp_path / "sharded" / "simulation.log").read()
    assert f"{P} chain shards of {4 // P} on cpu" in log


@pytest.mark.parametrize("backend", ["checkerboard", "dense"])
def test_pgmc_shards_match_unsharded(tmp_path, backend):
    """PGMC on 2 CPU shards: each shard estimates its chains on its block of
    the global proposal draws; the gathered estimates, and the parameters
    after update(), agree with the unsharded run to 1e-12 relative (on the
    CPU they come out bitwise)."""
    pool = (TMB.displacement(0.1, 0.6),
            TMB.discrete_swap(0, 1, 0.4, policy="energy_bias", theta1=0.3, theta2=-0.2))
    steps = 2
    sims = []
    for name, devices in (("ref", None), ("sharded", ["cpu"] * 2)):
        sim = Simulation(_chains(backend, temperatures=1.0), [
            _metropolis(backend, pool),
            dict(algorithm="PolicyGradientEstimator", optimisers=(TP.VPG(1e-3), TP.VPG(1e-2)), q_batch_size=3),
            dict(algorithm="PolicyGradientUpdate", scheduler=[steps]),
        ], steps, path=str(tmp_path / name), devices=devices)
        sim._run_chunk(steps)
        sim._pgmc.estimate()
        sims.append((sim, [None if a is None else [t.clone() for t in a[:2]] for a in sim._pgmc._acc]))
        sim._pgmc.update()
    (ref, acc_ref), (sh, acc_sh) = sims
    for a, b in zip(acc_ref, acc_sh):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or ()):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-12, atol=1e-300)
            assert torch.equal(x, y)  # bitwise on the CPU
    for pa, pb in zip(ref.pool_params, sh.pool_params):
        for k in pa:
            np.testing.assert_allclose(pb[k].numpy(), pa[k].numpy(), rtol=1e-12)
    assert float(sh.pool_params[0]["sigma"]) != 0.1
    _assert_same_state(ref.mc, sh.mc)


@pytest.mark.parametrize("backend", ["checkerboard", "dense"])
@pytest.mark.parametrize("write_p,resume_p", [(2, 1), (1, 2)], ids=["P2-to-P1", "P1-to-P2"])
def test_checkpoint_resumes_across_shard_counts(tmp_path, backend, write_p, resume_p):
    """A checkpoint written by a run on `write_p` shards resumes on
    `resume_p` and ends bitwise where the straight run ends."""
    steps, mid = 6, 3
    as_devices = {1: None, 2: ["cpu"] * 2}
    outs = [dict(algorithm="StoreCheckpoints", scheduler=[mid], history=True),
            dict(algorithm="StoreCallbacks", callbacks=("energy",), scheduler=build_schedule(steps, 0, 1))]
    straight = Simulation(_chains(backend), [_metropolis(backend)] + outs, steps,
                          path=str(tmp_path / "straight"), devices=as_devices[write_p])
    straight.run()
    resumed = Simulation(_chains(backend), [_metropolis(backend)] + outs[1:], steps,
                         path=str(tmp_path / "resumed"), devices=as_devices[resume_p],
                         resume=str(tmp_path / "straight" / f"checkpoint_{mid}.npz"))
    assert (resumed.mesh is None) == (resume_p == 1)
    resumed.run()
    _assert_same_state(straight.mc, resumed.mc)
    tail = open(tmp_path / "straight" / "chains" / "1" / "energy.dat").read().splitlines()[mid + 1:]
    assert open(tmp_path / "resumed" / "chains" / "1" / "energy.dat").read().splitlines() == tail


def test_uneven_chains_warns_not_silent(tmp_path):
    """The port's tests/test_simulation.py::test_uneven_chains_warns_not_silent
    over a list of 8 CPU devices: 3 chains warn and stay unsharded, 8 shard
    8 ways without a warning."""
    algorithms = [dict(algorithm="Metropolis", pool=(TMB.displacement(0.1),), seed=1)]
    with pytest.warns(RuntimeWarning, match="not divisible"):
        sim = Simulation(_chains("dense", 3, 1.0), algorithms, 1, path=str(tmp_path / "o1"), devices=["cpu"] * 8)
    assert sim.mesh is None and len(sim.shards) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim = Simulation(_chains("dense", 8, 1.0), algorithms, 1, path=str(tmp_path / "o2"), devices=["cpu"] * 8)
    assert sim.mesh is not None and sim.mesh.size == 8 and len(sim.shards) == 8


@pytest.fixture(scope="module")
def jax_sharded_run():
    """tests/test_tempering.py::test_sharded_chains_match_single_device's
    run over JAX's 8 virtual CPU devices, its start, and the draws and u it
    made, as the port takes them."""
    batch, jt = _ladder_batch(m=8)
    pool = (JMB.displacement(0.1),)
    config = JK.KernelConfig(pool=pool, table=jt, cell_spec=None)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    mc = jax.vmap(lambda s, k: JK.init_mc_state(s, config, k))(batch, keys)
    sweep_j = JK.build_sweep_fn(config, 32)
    key = jax.random.PRNGKey(9)

    def train(mcb, prm, key):
        mcb = jax.vmap(lambda m: sweep_j(m, prm))(mcb)
        mcb, _, _ = j_replica_exchange(mcb, key, 0)
        return mcb

    mesh_j = Mesh(np.asarray(jax.devices()[:8]), ("chains",))
    out_j = jax.jit(train)(jax.device_put(mc, NamedSharding(mesh_j, PartitionSpec("chains"))),
                           jax.device_put(JMB.init_pool_params(pool), NamedSharding(mesh_j, PartitionSpec())), key)
    _, draws = batched_draws(list(keys), pool, np.asarray(batch.species), 32, 2)
    return mc, out_j, draws, torch.tensor(np.asarray(_u(key)))


@pytest.mark.parametrize("P", [2, 8])
def test_sharded_sweep_and_exchange_match_jax(P, jax_sharded_run):
    """tests/test_tempering.py::test_sharded_chains_match_single_device's
    recipe: 8 ladder chains (N = 32), a Displacement sweep, then a
    replica-exchange pass at parity 0. JAX runs it over its 8 virtual CPU
    devices; the port over P CPU shards, the sweep fed JAX's draws and the
    pass JAX's u. Positions and energies within 1e-12 (JAX's own
    tolerance); the port's shards equal its unsharded run bitwise."""
    mc, out_j, draws, u = jax_sharded_run
    tpool = (TMB.displacement(0.1),)
    sweep_t = TK.build_sweep_fn(TK.KernelConfig(pool=tpool, table=TT.KobAndersen(device="cpu"), cell_spec=None), 32)
    params = TMB.init_pool_params(tpool, device="cpu")
    mc_t = port_mc_state(mc)
    mesh = PM.make_mesh(P, "cpu")
    shards = [sweep_t(s, params, draws) for s in PM.shard_chains(mc_t, mesh)]
    shards, att, acc = TTM.replica_exchange(shards, 0, u=u)
    got = PM.gather_chains(shards, mesh)
    assert int(acc.sum()) > 0
    np.testing.assert_allclose(got.system.position.numpy(), np.asarray(out_j.system.position), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.system.energy.numpy(), np.asarray(out_j.system.energy), rtol=1e-12)
    ref, _, acc_ref = TTM.replica_exchange(sweep_t(mc_t, params, draws), 0, u=u)
    assert torch.equal(acc, acc_ref)
    for f in ("position", "species", "energy"):
        assert torch.equal(getattr(got.system, f), getattr(ref.system, f)), f

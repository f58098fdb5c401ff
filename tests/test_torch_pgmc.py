"""The port's policy-guided MC (particlesmc_tpu_torch/engine/pgmc.py)
against the JAX package's, and the patterns of tests/test_pgmc.py on the
port.

Cross-package cases take their actions from the JAX package's sample_prop
(N = 43, the reference scenario's 2D JBB, 20:11:12, float64) and feed them
to the port. Tolerances: the surrogate's value, log q_fwd and autograd
gradient within 1e-9 of JAX's value and jax.grad; each chain's (g, F) within
1e-9 of JAX's vmapped per-sample estimate; one update() from the same
accumulators gives θ within rtol 1e-12."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.cli import main as j_main
from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core import neighbours as JNB
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.engine import pgmc as JP
from particlesmc_tpu.engine.simulation import Simulation as JSimulation
from particlesmc_tpu.io.loader import Chains as JChains
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch import cli, convert
from particlesmc_tpu_torch.core import neighbours as TNB
from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine import pgmc as TP
from particlesmc_tpu_torch.engine.schedule import build_schedule
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import kernel as TK

from .test_torch_engine import _layout, _write_config
from .test_torch_inputs import ka2d

torch.set_num_threads(1)

KA2D_DENSITY, KA2D_T = 1.1920748468939728, 0.5
M, Q = 2, 3  # chains and samples per chain of the cross-package cases


def port_chains(m, n_side=None, density=KA2D_DENSITY, list_type="dense", list_parameters=None):
    pos, sp, rho = ka2d(m, n_side, density)
    table = TT.JBB(torch.float64, "cpu")
    st = initialize_energy(make_system(pos, sp, rho, KA2D_T, device="cpu"), table)
    return Chains(states=st, table=table, list_type=list_type, list_parameters=list_parameters or {}, n_chains=m)


def jax_chains(m, density=KA2D_DENSITY):
    pos, sp, rho = ka2d(m, density=density)
    table = JT.JBB()
    sts = [JE.initialize_energy(j_make_system(pos[b], sp[b], rho, KA2D_T, dtype=jnp.float64), table)
           for b in range(m)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sts), table


def pools(**theta):
    """(JAX pool, port pool): tests/test_pgmc.py's finite-difference pool."""
    kw = dict(theta1=0.3, theta2=-0.2, **theta)
    return tuple(
        (mb.displacement(0.08, probability=0.8), mb.discrete_swap(0, 2, 0.2, policy="energy_bias", **kw))
        for mb in (JMB, TMB)
    )


def to_action(prop):
    """A JAX Proposal batch [M, Q] as the port's Action."""
    t = lambda x, dt=None: torch.tensor(np.asarray(x)) if dt is None else torch.tensor(np.asarray(x), dtype=dt)  # noqa: E731
    return TK.Action(i=t(prop.i, torch.int64), j=t(prop.j, torch.int64), pos_i=t(prop.pos_i),
                     sp_i=t(prop.sp_i, torch.int64), sp_j=t(prop.sp_j, torch.int64), delta=t(prop.delta))


@functools.lru_cache(maxsize=None)
def jax_case(move, cells):
    """JAX's actions [M, Q] from sample_prop at θ ≠ 0 and, per action, the
    surrogate's value, log q_fwd, jax.grad and score (JAX PGMC's
    per_sample), plus what the port needs to rebuild the same inputs."""
    density = 0.4 if cells else KA2D_DENSITY  # a cell grid needs 3 cells per side
    batch, table = jax_chains(M, density)
    pool_j, _ = pools()
    n = batch.position.shape[1]
    spec = JNB.make_spec(np.asarray(batch.box[0]), table.max_cutoff, n) if cells else None
    assert (spec is not None) == cells
    config = JK.KernelConfig(pool=pool_j, table=table, cell_spec=spec)
    cell = jax.vmap(lambda p, b: JNB.build_cell_list(p, b, spec))(batch.position, batch.box) if cells else None
    sample_prop, surrogate_at = JP.build_surrogate_fns(config, n)
    theta = JMB.init_pool_params(pool_j)[move]
    keys = jax.random.split(jax.random.PRNGKey(17 + move), M * Q).reshape(M, Q, -1)

    def per_sample(k, st, c):
        prop = sample_prop(theta, move, k, st, c)
        (val, lqf), g = jax.value_and_grad(lambda th: surrogate_at(prop, th, move, st, c), has_aux=True)(theta)
        s = jax.grad(lambda th: surrogate_at(prop, th, move, st, c)[1])(theta)
        return prop, val, lqf, g, s

    out = jax.jit(jax.vmap(jax.vmap(per_sample, in_axes=(0, None, None))))(keys, batch, cell)
    prop, val, lqf, g, s = jax.tree.map(np.asarray, out)
    names = sorted(theta)
    return dict(
        batch=batch, cells=None if spec is None else (spec.ncells, spec.cap), prop=prop, val=val, lqf=lqf,
        g=np.stack([g[k] for k in names], -1), s=np.stack([s[k] for k in names], -1), names=names,
    )


def port_inputs(case):
    """The port's config, system and cell list of a cached JAX case."""
    b = case["batch"]
    system = convert.system_from_numpy(
        np.asarray(b.position), np.asarray(b.species), np.asarray(b.box), np.asarray(b.density),
        np.asarray(b.temperature), np.asarray(b.energy), device="cpu",
    )
    _, pool_t = pools()
    spec = None if case["cells"] is None else TNB.CellSpec(*case["cells"])
    config = TK.KernelConfig(pool=pool_t, table=TT.JBB(torch.float64, "cpu"), cell_spec=spec)
    cell = None if spec is None else TNB.build_cell_list(system.position, system.box, spec)
    return config, system, cell


CASES = [(0, False), (1, False), (1, True)]
CASE_IDS = ["displacement", "energy_bias", "energy_bias-force_cells"]


@pytest.mark.parametrize("move,cells", CASES, ids=CASE_IDS)
def test_surrogate_matches_jax(move, cells):
    """On JAX's sampled actions at θ ≠ 0: the port's surrogate value, its
    log q_fwd and its autograd gradient equal JAX's within 1e-9."""
    case = jax_case(move, cells)
    config, system, cell = port_inputs(case)
    _, surrogate_at = TP.build_surrogate_fns(config, system.n_particles)
    pool_j, _ = pools()
    params = convert.pool_params_from_numpy(jax.tree.map(np.asarray, JMB.init_pool_params(pool_j)), device="cpu")
    theta = {k: params[move][k].expand(M, Q).clone().requires_grad_(True) for k in case["names"]}
    val, lqf = surrogate_at(to_action(case["prop"]), theta, move, system, cell)
    grads = torch.autograd.grad(val.sum(), [theta[k] for k in case["names"]])
    np.testing.assert_allclose(val.detach().numpy(), case["val"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lqf.detach().numpy(), case["lqf"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(torch.stack(grads, -1).numpy(), case["g"], rtol=1e-9, atol=1e-12)
    assert (case["val"] > 0).any() and np.abs(case["g"]).max() > 1e-8  # live actions


def test_logq_of_parameter_free_moves_matches_jax():
    """make_logq_fns of a DoubleUniform swap and a MoleculeFlip equal the JAX
    package's: −log(n1·n2) and −log 2, forward and reverse."""
    batch, table = jax_chains(M)
    pool_j = (JMB.discrete_swap(0, 2, 0.5), JMB.molecule_flip(0.5))
    pool_t = (TMB.discrete_swap(0, 2, 0.5), TMB.molecule_flip(0.5))
    fns_j = JK.make_logq_fns(JK.KernelConfig(pool=pool_j, table=table, cell_spec=None), 43)
    config, system, _ = port_inputs({"batch": batch, "cells": None})
    fns_t = TK.make_logq_fns(dataclasses.replace(config, pool=pool_t), 43)
    z = torch.zeros((M, Q), dtype=torch.int64)
    action = TK.Action(i=z, j=z + 1, pos_i=torch.zeros(M, Q, 2), sp_i=z, sp_j=z, delta=torch.zeros(M, Q, 2))
    for fj, ft in zip(fns_j, fns_t):
        for b in range(M):
            st = jax.tree.map(lambda x: x[b], batch)
            ref = [float(v) for v in fj(None, st, None, {})]
            for v, r in zip(ft(action, system, None, {}), ref):
                assert v.shape == (M, Q)
                np.testing.assert_allclose(v[b].numpy(), r, rtol=1e-15)


def _port_sim(tmp_path, pool, optimisers, m=M, q=Q, **metro):
    chains = port_chains(m)
    algos = [
        dict(algorithm="Metropolis", pool=pool, seed=3, **metro),
        dict(algorithm="PolicyGradientEstimator", optimisers=optimisers, q_batch_size=q),
        dict(algorithm="PolicyGradientUpdate", scheduler=[1]),
    ]
    return Simulation(chains, algos, 1, path=str(tmp_path))


@pytest.mark.parametrize("move", [0, 1], ids=["displacement", "energy_bias"])
def test_estimator_matches_jax(tmp_path, move):
    """Each chain's gradient g (the mean over its samples) and Fisher matrix
    F = sᵀs / Q from the port's estimator on JAX's actions equal JAX's
    per-sample values reduced the same way, within 1e-9; estimate() books
    their means over the chains."""
    case = jax_case(move, False)
    _, pool_t = pools()
    sim = _port_sim(tmp_path, pool_t, (TP.VPG(1e-3), TP.VPG(1e-2)))
    pg = sim._pgmc
    g, fisher = pg.per_chain(move, to_action(case["prop"]))
    g_ref = case["g"].mean(axis=1)
    f_ref = np.einsum("bqi,bqj->bij", case["s"], case["s"]) / Q
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fisher.numpy(), f_ref, rtol=1e-9, atol=1e-12)
    props = [None, None]
    props[move] = to_action(case["prop"])
    pg.learnable = [k == move for k in range(2)]
    pg.estimate(props)
    acc_g, acc_f, cnt = pg._acc[move]
    assert cnt == 1
    np.testing.assert_allclose(acc_g.numpy(), g_ref.mean(axis=0), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(acc_f.numpy(), f_ref.mean(axis=0), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("opt", ["VPG", "BLANPG"])
def test_update_matches_jax(tmp_path, opt):
    """One update() from the same accumulators (two estimates booked) gives
    the same θ in both packages, rtol 1e-12."""
    pool_j, pool_t = pools()
    mk = {"VPG": lambda mod: mod.VPG(3e-2), "BLANPG": lambda mod: mod.BLANPG(1e-4, 1e-6)}[opt]
    sim = _port_sim(tmp_path / "port", pool_t, (TP.VPG(1e-3), mk(TP)))
    batch, table = jax_chains(M)
    jsim = JSimulation(
        JChains(states=batch, table=table, list_type="dense", n_chains=M),
        [dict(algorithm="Metropolis", pool=pool_j, seed=3),
         dict(algorithm="PolicyGradientEstimator", optimisers=(JP.VPG(1e-3), mk(JP)), q_batch_size=Q),
         dict(algorithm="PolicyGradientUpdate", scheduler=[1])],
        1, path=str(tmp_path / "jax"),
    )
    g = {0: np.asarray([0.37]), 1: np.asarray([0.61, -1.27])}
    f = {0: np.asarray([[2.3]]), 1: np.asarray([[2.0, 0.3], [0.3, 0.9]])}
    for m in (0, 1):
        names = sorted(dict(pool_j[m].params))
        jsim._pgmc._acc[m] = [{k: jnp.asarray(g[m][i]) for i, k in enumerate(names)}, jnp.asarray(f[m]), 2]
        sim._pgmc._acc[m] = [torch.tensor(g[m]), torch.tensor(f[m]), 2]
    jsim._pgmc.update()
    sim._pgmc.update()
    for m in (0, 1):
        assert list(sim.pool_params[m]) == list(jsim.pool_params[m])
        for k, v in jsim.pool_params[m].items():
            np.testing.assert_allclose(float(sim.pool_params[m][k]), float(v), rtol=1e-12)
        assert sim._pgmc._acc[m] is None
    assert float(sim.pool_params[1]["theta1"]) != 0.3


def test_reward_definitions():
    """tests/test_pgmc.py::test_reward_definitions on the port: |δ|² for a
    displacement, 1 for a swap."""
    z = torch.zeros(1, dtype=torch.int64)
    prop = TK.Action(i=z, j=z, pos_i=torch.zeros(1, 2), sp_i=z, sp_j=z, delta=torch.tensor([[0.3, 0.4]]))
    system = port_chains(1).states
    assert float(TK.move_reward(TMB.displacement(0.1))(prop, system)[0]) == pytest.approx(0.25)
    assert float(TK.move_reward(TMB.discrete_swap(0, 1, 0.5))(prop, system)[0]) == 1.0


def _cb_algorithms(pool, q_every, steps):
    return [
        dict(algorithm="Metropolis", pool=pool, seed=7, parallel_moves=True),
        dict(algorithm="PolicyGradientEstimator", optimisers=(TP.VPG(1e-3),), q_batch_size=2, q_every=q_every),
        dict(algorithm="PolicyGradientUpdate", scheduler=build_schedule(steps, 0, q_every)),
    ]


def test_cb_sigma_guard_warns_past_quarter_cell(tmp_path):
    """tests/test_pgmc.py's guard on the port: a learned σ past cell side / 4
    on the checkerboard backend warns at the update."""
    chains = port_chains(1, n_side=16)
    sim = Simulation(chains, _cb_algorithms((TMB.displacement(0.05),), 1, 2), 2, path=str(tmp_path))
    pg = sim._pgmc
    assert pg._sigma_proxy_limit is not None and pg.config.cell_spec is None
    sim.pool_params = ({"sigma": torch.tensor(pg._sigma_proxy_limit * 2.0, dtype=torch.float64)},)
    pg.estimate()
    with pytest.warns(RuntimeWarning, match="cell_side/4"):
        pg.update()


def test_smart_gaussian_and_cli_refusals(tmp_path):
    """PGMC refuses a SmartGaussian pool and a pool without one optimiser per
    move; the CLI refuses the estimator (library-only, as in JAX)."""
    chains = port_chains(1, n_side=16)
    with pytest.raises(ValueError, match="SmartGaussian"):
        Simulation(chains, _cb_algorithms((TMB.displacement_smart(0.05),), 1, 2), 2, path=str(tmp_path))
    algos = _cb_algorithms((TMB.displacement(0.05), TMB.discrete_swap(0, 1, 0.1)), 1, 2)
    with pytest.raises(ValueError, match="one optimiser per move"):
        Simulation(chains, algos, 2, path=str(tmp_path))
    with pytest.raises(ValueError, match="library only"):
        cli._build_outputs([{"algorithm": "PolicyGradientEstimator"}], 10, 0)


def test_surrogate_gradient_matches_finite_differences():
    """tests/test_pgmc.py's check on the port: autograd of the surrogate at a
    fixed sampled action equals the central finite difference of the
    undetached objective exp(lqf(θ) − lqf(θ0)) · L(θ), for σ and for both
    EnergyBias θ."""
    chains = port_chains(1)
    _, pool = pools()
    config = TK.KernelConfig(pool=pool, table=chains.table, cell_spec=None)
    sample_prop, surrogate_at = TP.build_surrogate_fns(config, chains.n_particles)
    params = TMB.init_pool_params(pool, device="cpu")
    st = chains.states
    gen = torch.Generator().manual_seed(100)
    for m in range(len(pool)):
        theta0 = {k: v.clone() for k, v in params[m].items()}
        prop = sample_prop(theta0, m, gen, st, None, 16)  # 16 actions, one chain

        def f(theta):
            with torch.no_grad():
                val, lqf = surrogate_at(prop, theta, m, st, None)
                lqf0 = surrogate_at(prop, theta0, m, st, None)[1]
            return torch.exp(lqf - lqf0) * val

        live = f(theta0)[0] > 1e-6
        assert live.any(), f"no live action for move {m}"
        leaves = {k: v.expand(1, 16).clone().requires_grad_(True) for k, v in theta0.items()}
        val, _ = surrogate_at(prop, leaves, m, st, None)
        grads = torch.autograd.grad(val.sum(), list(leaves.values()))
        h = 1e-5
        for (name, v), g in zip(theta0.items(), grads):
            fd = (f(dict(theta0, **{name: v + h})) - f(dict(theta0, **{name: v - h}))) / (2 * h)
            fd, ad = fd[0][live], g[0][live]
            assert torch.all((ad - fd).abs() < 1e-4 * torch.clamp_min(fd.abs(), 1.0)), (m, name, ad, fd)
            assert float(ad.abs().max()) > 1e-8


def test_store_parameters_cli_matches_jax(tmp_path):
    """StoreParameters through both CLIs: the same file layout and the same
    parameters.dat rows ("step v1 v2 ...", a move without parameters writes
    none)."""
    _write_config(tmp_path / "config.xyz", n=48, density=0.5)
    text = f"""
[system]
config = "{tmp_path / 'config.xyz'}"
temperature = 1.5
density = 0.5
model = "JBB"
list_type = "EmptyList"

[simulation]
type = "Metropolis"
steps = 4
seed = 3
verbose = false
output_path = "{{out}}"

[[simulation.move]]
action = "Displacement"
probability = 0.7
policy = "SimpleGaussian"
parameters = {{sigma = 0.07}}

[[simulation.move]]
action = "DiscreteSwap"
probability = 0.3
policy = "DoubleUniform"
parameters = {{species = [1, 2]}}

[[simulation.output]]
algorithm = "StoreParameters"
scheduler_params = {{linear_interval = 2}}
"""
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", j_main, [])):
        p = tmp_path / f"{name}.toml"
        p.write_text(text.replace("{out}", str(tmp_path / name)))
        assert main([str(p)] + extra) == 0
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax")
    for m in (1, 2):
        rows = (tmp_path / "port" / "moves" / str(m) / "parameters.dat").read_text()
        assert rows == (tmp_path / "jax" / "moves" / str(m) / "parameters.dat").read_text()
    assert rows == "" and (tmp_path / "port" / "moves" / "1" / "parameters.dat").read_text() == (
        "0 0.07\n2 0.07\n4 0.07\n"
    )


# ---------------------------------------------------------------------------
# tests/test_pgmc.py's slow patterns on the port, a few seconds here
# ---------------------------------------------------------------------------


def test_pgmc_learns_parameters(tmp_path):
    chains = port_chains(3)
    pool = (
        TMB.displacement(0.05, probability=0.8),
        TMB.discrete_swap(0, 2, 0.1, policy="energy_bias"),
        TMB.discrete_swap(1, 2, 0.1, policy="energy_bias"),
    )
    steps = 6
    sched = build_schedule(steps, 0, 2)
    algorithms = [
        dict(algorithm="Metropolis", pool=pool, seed=42),
        dict(algorithm="PolicyGradientEstimator", optimisers=(TP.VPG(1e-3), TP.BLANPG(1e-4, 1e-6),
                                                               TP.BLANPG(1e-4, 1e-6)), q_batch_size=4),
        dict(algorithm="PolicyGradientUpdate", scheduler=sched),
        dict(algorithm="StoreParameters", scheduler=sched),
        dict(algorithm="StoreCallbacks", callbacks=("energy",), scheduler=sched),
    ]
    sim = Simulation(chains, algorithms, steps, path=str(tmp_path)).run()
    sigma = float(sim.pool_params[0]["sigma"])
    th1, th2 = float(sim.pool_params[1]["theta1"]), float(sim.pool_params[1]["theta2"])
    assert np.isfinite([sigma, th1, th2]).all() and sigma > 0
    assert sigma != pytest.approx(0.05) and (th1, th2) != (0.0, 0.0)
    assert np.loadtxt(tmp_path / "moves" / "1" / "parameters.dat").shape[0] == len(sched)
    assert np.loadtxt(tmp_path / "moves" / "2" / "parameters.dat").shape[1] == 3
    st = sim.mc.system
    e = total_energy_dense(st.position, st.species, st.box, chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e.numpy(), rtol=1e-9)


def test_pgmc_learns_sigma_on_checkerboard_backend(tmp_path):
    chains = port_chains(2, n_side=16)
    steps = 6
    algos = _cb_algorithms((TMB.displacement(0.05),), 2, steps)
    algos[1]["q_batch_size"] = 4
    algos.append(dict(algorithm="StoreParameters", scheduler=build_schedule(steps, 0, 2)))
    sim = Simulation(chains, algos, steps, path=str(tmp_path))
    assert sim.parallel_moves
    sim.run()
    sigma = float(sim.pool_params[0]["sigma"])
    assert np.isfinite(sigma) and sigma > 0 and sigma != pytest.approx(0.05)
    assert int(sim.mc.attempted.sum()) > 0
    assert np.loadtxt(tmp_path / "moves" / "1" / "parameters.dat").shape[0] == 4


def test_score_gradient_agrees_with_pathwise_derivative():
    """The mean score-function gradient of J(σ) agrees with the pathwise
    derivative of Ĵ(σ) = mean[A·|δ|²] under common random numbers (δ = σ·z),
    and both point uphill at σ = 0.3."""
    chains = port_chains(1)
    st = chains.states
    pool = (TMB.displacement(0.05),)
    config = TK.KernelConfig(pool=pool, table=chains.table, cell_spec=None)
    sample_prop, surrogate_at = TP.build_surrogate_fns(config, chains.n_particles)
    K = 2048
    s0, h = 0.3, 1e-3

    def actions(sigma):
        gen = torch.Generator().manual_seed(7)
        return sample_prop({"sigma": torch.tensor(sigma, dtype=torch.float64)}, 0, gen, st, None, K)

    theta = {"sigma": torch.full((1, K), s0, dtype=torch.float64, requires_grad=True)}
    val, _ = surrogate_at(actions(s0), theta, 0, st, None)
    g = torch.autograd.grad(val.sum(), [theta["sigma"]])[0][0]
    g_mean, se = float(g.mean()), float(g.std() / np.sqrt(K))

    def j_hat(sigma):
        th = {"sigma": torch.tensor(sigma, dtype=torch.float64)}
        with torch.no_grad():
            return float(surrogate_at(actions(sigma), th, 0, st, None)[0].mean())

    fd = (j_hat(s0 + h) - j_hat(s0 - h)) / (2 * h)
    assert abs(g_mean - fd) < 4 * se, (g_mean, fd, se)
    assert g_mean > 0 and fd > 0


def test_unported_pgmc_and_checkpoint_outputs_are_gone():
    """The engine accepts every output of the JAX package's engine but the
    callbacks of ROADMAP item 12."""
    from particlesmc_tpu_torch.engine import simulation as S

    for name in ("PolicyGradientEstimator", "PolicyGradientUpdate", "StoreParameters", "StoreCheckpoints"):
        assert name in S.OUTPUTS
    assert set(S.UNPORTED_CALLBACKS) == {"pressure", "chain_correlation"}
    assert not hasattr(S, "UNPORTED_OUTPUTS")

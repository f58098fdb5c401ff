"""Chains whose boxes differ by rounding share one grid in both packages:
the box test is numpy's allclose against chain 0's box, and the grid is
built from chain 0's box (JAX engine/simulation.py sets `shared_box` so).

Two chains of 2D KA, N = 43 at rho = 0.4 (a 4 x 4 checkerboard grid and a
4 x 4 cell list), the second box 1e-9 longer per side. Both engines accept
them on the checkerboard and on the sequential cell path; one call on the
same draws gives the same counters and species and positions within 1e-9
(the port's checkerboard cell bounds come from chain 0's box, the JAX
package's from each chain's own, which can matter only for a particle
within ~1e-9 of a cell face). Boxes 1e-3 apart raise in both."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core import neighbours as JNB
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.engine.simulation import Simulation as JSimulation
from particlesmc_tpu.io.loader import Chains as JChains
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import kernel as TK

from .test_torch_cb_moves import reference_draws as cb_draws
from .test_torch_checkerboard import port_cb_state, port_system
from .test_torch_kernel import batched_draws, port_mc_state

torch.set_num_threads(1)

N, DENSITY, TEMPERATURE, INNER, STEPS = 43, 0.4, 1.0, 2, 43


def _states(gap):
    """Two JAX chains, the second box (and its positions) scaled so that
    each side is `gap` longer."""
    rng = np.random.default_rng(5)
    L = (N / DENSITY) ** 0.5
    per = int(np.ceil(N ** 0.5))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * 2, indexing="ij"), -1).reshape(-1, 2)[:N]
    table = JT.KobAndersen()
    states = []
    for k in range(2):
        scale = (L + k * gap) / L
        pos = (grid + rng.uniform(-0.05 * a, 0.05 * a, (N, 2))) * scale
        st = j_make_system(pos, rng.integers(1, 3, N), DENSITY, TEMPERATURE, box=np.full(2, L * scale))
        states.append(JE.initialize_energy(st, table))
    return states, table


LIST_PARAMETERS = {"inner": INNER, "force_cells": True}


def _metro(mb, backend):
    return dict(algorithm="Metropolis", pool=(mb.displacement(0.1),), seed=1,
                parallel_moves=backend == "checkerboard", sweepstep=STEPS)


def _jax_sim(states, table, backend):
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    chains = JChains(states=batch, table=table, list_type="cell", list_parameters=LIST_PARAMETERS, n_chains=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU mesh's idle devices, the cell path's speed
        return JSimulation(chains, [_metro(JMB, backend)], 1, path="unused")


def _port_sim(states, backend):
    chains = Chains(states=port_system(states), table=TT.KobAndersen(device="cpu"), list_type="cell",
                    list_parameters=LIST_PARAMETERS, n_chains=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the cell path's speed
        return Simulation(chains, [_metro(TMB, backend)], 1, path="unused")


@pytest.mark.parametrize("backend", ["checkerboard", "sequential_cells"])
def test_boxes_within_allclose_share_a_grid(backend):
    states, table = _states(1e-9)
    assert float(states[1].box[0] - states[0].box[0]) == pytest.approx(1e-9, rel=1e-3)
    tsim = _port_sim(states, backend)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    box0 = np.asarray(batch.box[0])
    assert np.allclose(np.asarray(batch.box), box0[None])  # the JAX engine's shared_box test
    pool_j = (JMB.displacement(0.1),)
    params_j = JMB.init_pool_params(pool_j)
    params_t = TMB.init_pool_params((TMB.displacement(0.1),), device="cpu")
    if backend == "checkerboard":
        spec = _jax_sim(states, table, backend).cb_spec
        assert tsim.cb_spec.ncells == spec.ncells == (4, 4) and tsim.cb_spec.cap == spec.cap
        cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=1) for st, s in zip(states, (3, 4))]
        fn = jax.jit(jax.vmap(JCB.build_hyper_sweep_fn(spec, table, N, STEPS, inner=INNER, pool=pool_j),
                              in_axes=(0, None)))
        out_j = fn(jax.tree.map(lambda *x: jnp.stack(x), *cbs), params_j)
        C, A = 4, spec.n_active
        R = max(1, -(-STEPS // (A * INNER * C)))
        draws = [cb_draws(cb.key, 2, R, C, INNER, A, False) for cb in cbs]
        draws = {k: torch.tensor(np.stack([d[k] for d in draws])) for k in draws[0]}
        out_t = tsim._block(1)(port_cb_state(tsim.mc.system, cbs), params_t, **draws)
    else:
        # the grid the JAX engine builds (its Simulation cannot be built on
        # this path: test_reference_sequential_cell_engine_fault)
        spec = JNB.make_spec(box0, table.max_cutoff, N)
        assert tsim.config.cell_spec.ncells == spec.ncells and tsim.neighbour_mode == "cell"
        keys = [jax.random.PRNGKey(s) for s in (11, 12)]
        config = JK.KernelConfig(pool=pool_j, table=table, cell_spec=spec, sweepstep=STEPS)
        mc_j0 = jax.vmap(lambda st, k: JK.init_mc_state(st, config, k))(batch, jnp.stack(keys))
        out_j = jax.jit(jax.vmap(JK.build_sweep_fn(config, N), in_axes=(0, None)))(mc_j0, params_j)
        _, draws = batched_draws(keys, pool_j, np.asarray(batch.species), STEPS, 2)
        out_t = TK.build_sweep_fn(tsim.config, N)(port_mc_state(mc_j0), params_t, draws)
        assert not out_t.cell.overflow.any()
    np.testing.assert_array_equal(out_t.attempted.numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted.numpy(), np.asarray(out_j.accepted))
    np.testing.assert_array_equal(out_t.system.species.numpy(), np.asarray(out_j.system.species))
    np.testing.assert_allclose(out_t.system.position.numpy(), np.asarray(out_j.system.position), rtol=0, atol=1e-9)
    assert int(out_t.accepted.sum()) > 0
    assert not torch.equal(out_t.system.box[0], out_t.system.box[1])  # each chain keeps its box


@pytest.mark.parametrize("backend", ["checkerboard", "sequential_cells"])
def test_boxes_past_allclose_raise(backend):
    states, table = _states(1e-3)
    with pytest.raises(ValueError, match="share one box"):
        _jax_sim(states, table, backend)
    with pytest.raises(ValueError, match="share one box"):
        _port_sim(states, backend)


def test_reference_sequential_cell_engine_fault():
    """A fault of the JAX package, pinned here because that package is not
    edited: its Simulation raises UnboundLocalError on the sequential cell
    path, whose speed warning (particlesmc_tpu/engine/simulation.py:156)
    calls `warnings`, which a later function-local `import warnings` (:443)
    makes a local name. The port builds the same run."""
    states, table = _states(0.0)
    with pytest.raises(UnboundLocalError):
        _jax_sim(states, table, "sequential_cells")
    assert _port_sim(states, "sequential_cells").neighbour_mode == "cell"

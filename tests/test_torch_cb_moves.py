"""Parity of the port's swap, EnergyBias and SmartGaussian sub-moves
(moves/checkerboard.py) with the JAX package's, one hyper-sweep call each
with the same shift and the same draws.

The JAX side runs its XLA path: the JAX package uses its Pallas kernel only
for all-Gaussian pools. The port runs its Gaussian slots through the
kernel's plain version, whose in-cell test is membership of [lo, hi) and
whose accept test is ΔE < -T log u, where the XLA path compares floor(x /
box * nc) with the cell coordinate and log u with -ΔE / T. The two can
disagree only on measure-zero float boundaries, which these draws do not
hit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .test_torch_checkerboard import jax_chains, port_cb_state, port_system

torch.set_num_threads(1)

N, D, INNER = 122, 2, 2
TEMPERATURE, DENSITY = 1.5, 1.0


def reference_draws(key, d, R, C, inner, A, with_up2):
    """The shift and draws build_hyper_sweep_fn makes from a chain's key,
    with the second pick `up2` of pools that swap or flip."""
    dt = jnp.float64
    _, k_shift, k_rand = jax.random.split(key, 3)
    shift = jax.random.uniform(k_shift, (d,), dt)
    k_pick, k_pick2, k_delta, k_acc = jax.random.split(k_rand, 4)
    out = dict(
        shift=shift,
        up=jax.random.uniform(k_pick, (R, C, inner, A), dt, maxval=1.0 - 1e-7),
        ua=jax.random.uniform(k_acc, (R, C, inner, A), dt, minval=jnp.finfo(dt).tiny),
        dl=jax.random.normal(k_delta, (R, C, inner, d, A), dt),
    )
    if with_up2:
        out["up2"] = jax.random.uniform(k_pick2, (R, C, inner, A), dt, maxval=1.0 - 1e-7)
    return {k: np.asarray(v) for k, v in out.items()}


def _pools(kind):
    """(JAX pool, port pool) of one kind."""
    def both(name, *a, **kw):
        return getattr(JMB, name)(*a, **kw), getattr(TMB, name)(*a, **kw)

    if kind == "double_uniform":
        moves = [both("discrete_swap", 0, 1, 1.0)]
    elif kind == "energy_bias":
        moves = [both("discrete_swap", 0, 1, 1.0, policy="energy_bias", theta1=0.7, theta2=-0.4)]
    elif kind == "smart":
        moves = [both("displacement_smart", 0.12)]
    else:  # Gaussian displacements mixed with swaps: the kernel runs are split
        moves = [both("displacement", 0.1, 0.7), both("discrete_swap", 0, 1, 0.3)]
    return tuple(m[0] for m in moves), tuple(m[1] for m in moves)


def _parity(kind, seeds=(3, 4)):
    """One hyper-sweep call on len(seeds) chains through both packages."""
    states, jt = jax_chains(N, D, seeds, density=DENSITY)
    states = [s.replace(temperature=jnp.asarray(TEMPERATURE)) for s in states]
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, N)
    assert spec.ncells == (4, 4)
    pool_j, pool_t = _pools(kind)
    fn = jax.jit(
        jax.vmap(JCB.build_hyper_sweep_fn(spec, jt, N, inner=INNER, pool=pool_j), in_axes=(0, None))
    )
    cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=len(pool_j)) for st, s in zip(states, seeds)]
    out_j = fn(jax.tree.map(lambda *x: jnp.stack(x), *cbs), JMB.init_pool_params(pool_j))

    C, A = 2**D, spec.n_active
    R = max(1, -(-N // (A * INNER * C)))
    with_up2 = any(m.action == "swap" for m in pool_t)
    draws = [reference_draws(cb.key, D, R, C, INNER, A, with_up2) for cb in cbs]
    draws = {k: torch.tensor(np.stack([dr[k] for dr in draws])) for k in draws[0]}

    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    table = TT.KobAndersen(device="cpu")
    cb_t = port_cb_state(port_system(states), cbs)
    hs = TCB.build_hyper_sweep_fn(tspec, table, N, inner=INNER, pool=pool_t)
    out_t = hs(cb_t, TMB.init_pool_params(pool_t, device="cpu"), **draws)
    return out_j, out_t, cb_t, table


@pytest.mark.parametrize("kind", ["double_uniform", "energy_bias", "smart", "mixed"])
def test_hyper_sweep_matches_jax(kind):
    """Same attempted/accepted counters and species, positions within 1e-9,
    energy within rtol 1e-9; the ledger equals a dense recompute, and a swap
    keeps each chain's composition."""
    out_j, out_t, cb0, table = _parity(kind)
    np.testing.assert_array_equal(out_t.attempted.numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted.numpy(), np.asarray(out_j.accepted))
    np.testing.assert_array_equal(out_t.system.species.numpy(), np.asarray(out_j.system.species))
    np.testing.assert_allclose(
        out_t.system.position.numpy(), np.asarray(out_j.system.position), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(out_t.system.energy.numpy(), np.asarray(out_j.system.energy), rtol=1e-9)
    st = out_t.system
    e_dense = TE.total_energy_dense(st.position, st.species, st.box, table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    assert (out_t.accepted > 0).all(), out_t.accepted
    np.testing.assert_array_equal(
        np.sort(st.species.numpy(), axis=1), np.sort(cb0.system.species.numpy(), axis=1)
    )
    if kind != "smart":  # the species really moved
        assert (st.species != cb0.system.species).any()


def test_softmax_pick_matches_jax():
    """The masked-softmax pick and its log-probability on fixed logits,
    including a cell without members and a -inf logit."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0.0, 2.0, (7, 9))
    logits[2, 3] = -np.inf
    memb = rng.random((7, 9)) < 0.6
    memb[4] = False
    for u in (rng.uniform(0, 1 - 1e-7, 7), np.zeros(7), np.full(7, 1 - 1e-7)):
        pj, lj = JCB._softmax_pick(jnp.asarray(logits), jnp.asarray(memb), jnp.asarray(u))
        pt, lt = TCB._softmax_pick(torch.tensor(logits), torch.tensor(memb), torch.tensor(u))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12)
        assert not pt[4].any()
    # batched over a chains axis, as the hyper-sweep calls it
    pb, lb = TCB._softmax_pick(torch.tensor(logits)[None].repeat(2, 1, 1),
                               torch.tensor(memb)[None].repeat(2, 1, 1), torch.tensor(u)[None].repeat(2, 1))
    assert torch.equal(pb[1], pt) and torch.equal(lb[0], lt)


def test_theta_zero_is_uniform_swap():
    """EnergyBias with theta = 0 makes the DoubleUniform swap's decisions on
    the same draws: same positions, species and counters, bitwise."""
    states, _ = jax_chains(N, D, [5, 6], density=DENSITY)
    system = port_system(states)
    system = system.replace(temperature=torch.full_like(system.temperature, TEMPERATURE))
    table = TT.KobAndersen(device="cpu")
    tspec = TCB.make_cb_spec(system.box[0].numpy(), table.max_cutoff, N)
    C, A = 2**D, tspec.n_active
    R = 2 * max(1, -(-N // (A * INNER * C)))
    g = np.random.default_rng(1)
    draws = dict(
        shift=g.uniform(0, 1, (2, D)),
        up=g.uniform(0, 1 - 1e-7, (2, R, C, INNER, A)),
        ua=g.uniform(1e-300, 1, (2, R, C, INNER, A)),
        dl=g.normal(0, 1, (2, R, C, INNER, D, A)),
        up2=g.uniform(0, 1 - 1e-7, (2, R, C, INNER, A)),
    )
    outs = []
    for swap in (TMB.discrete_swap(0, 1, 0.3), TMB.discrete_swap(0, 1, 0.3, policy="energy_bias")):
        pool = (TMB.displacement(0.08, 0.7), swap)
        hs = TCB.build_hyper_sweep_fn(tspec, table, N, inner=INNER, sweeps=2, pool=pool)
        cb = TCB.init_cb_state(system, tspec, seed=0, n_moves=2)
        outs.append(hs(cb, TMB.init_pool_params(pool, device="cpu"),
                       **{k: torch.tensor(v) for k, v in draws.items()}))
    a, b = outs
    assert torch.equal(a.system.position, b.system.position)
    assert torch.equal(a.system.species, b.system.species)
    assert torch.equal(a.accepted, b.accepted) and torch.equal(a.attempted, b.attempted)
    assert int(a.accepted[:, 1].sum()) > 0


def test_swap_pool_draws_and_refusals():
    """A swap pool draws up2 after the three draws of a displacement pool,
    so a displacement pool's stream is unchanged; injected draws must come
    with up2 exactly when the pool swaps."""
    states, _ = jax_chains(N, D, [7], density=DENSITY)
    system = port_system(states)
    table = TT.KobAndersen(device="cpu")
    tspec = TCB.make_cb_spec(system.box[0].numpy(), table.max_cutoff, N)
    disp = (TMB.displacement(0.1),)
    swap = (TMB.displacement(0.1, 0.8), TMB.discrete_swap(0, 1, 0.2))
    hs_d = TCB.build_hyper_sweep_fn(tspec, table, N, inner=INNER, pool=disp)
    hs_s = TCB.build_hyper_sweep_fn(tspec, table, N, inner=INNER, pool=swap)
    cb_d = TCB.init_cb_state(system, tspec, seed=3, n_moves=1)
    cb_s = TCB.init_cb_state(system, tspec, seed=3, n_moves=2)
    hs_d(cb_d, TMB.init_pool_params(disp, device="cpu"))
    hs_s(cb_s, TMB.init_pool_params(swap, device="cpu"))
    # one shift, then per round three draws for both pools, a fourth for the swap pool
    C, A = 2**D, tspec.n_active
    R = max(1, -(-N // (A * INNER * C)))
    g = torch.Generator()
    g.manual_seed(3)
    torch.rand((1, D), generator=g, dtype=torch.float64)
    for _ in range(R):
        torch.rand((1, C, INNER, A), generator=g, dtype=torch.float64)
        torch.rand((1, C, INNER, A), generator=g, dtype=torch.float64)
        torch.randn((1, C, INNER, D, A), generator=g, dtype=torch.float64)
    assert torch.equal(g.get_state(), cb_d.generator.get_state())
    z = torch.zeros((1, R, C, INNER, A), dtype=torch.float64)
    dl = torch.zeros((1, R, C, INNER, D, A), dtype=torch.float64)
    with pytest.raises(ValueError, match="up2"):
        hs_s(cb_s, TMB.init_pool_params(swap, device="cpu"), up=z, ua=z + 0.5, dl=dl)
    with pytest.raises(ValueError, match="up2"):
        hs_d(cb_d, TMB.init_pool_params(disp, device="cpu"), up=z, ua=z + 0.5, dl=dl, up2=z)


def test_schedule_segments():
    """Maximal runs of consecutive SimpleGaussian slots go to the kernel as
    one segment each; an all-Gaussian colour is one segment."""
    g, s = TMB.displacement(0.1), TMB.discrete_swap(0, 1, 0.5)
    pool = (g, s, TMB.displacement_smart(0.1))
    assert TCB.schedule_segments([0, 0, 1, 0, 2, 0, 0, 0], pool, kernel=True) == [
        (0, 2, True), (2, 3, False), (3, 4, True), (4, 5, False), (5, 8, True)
    ]
    assert TCB.schedule_segments([0] * 6, pool, kernel=True) == [(0, 6, True)]
    assert TCB.schedule_segments([0, 1], pool, kernel=False) == [(0, 1, False), (1, 2, False)]

"""Parity of the port's checkerboard hyper-sweep (moves/checkerboard.py) with
the JAX package's Pallas path, run in interpret mode on the CPU.

The reference's shift and draws are recomputed from each chain's key splits
and injected into the port, so both packages make the same moves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu_torch import convert
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .test_torch_inputs import lattice

torch.set_num_threads(1)

SIGMA = 0.1


def jax_chains(n, d, seeds, density=1.2):
    """One JAX SystemState per seed (KA, energy initialised) and the table."""
    jt = JT.KobAndersen()
    states = []
    for s in seeds:
        pos, sp = lattice(n, d, density, s)
        states.append(JE.initialize_energy(j_make_system(pos, sp, density, 1.0), jt))
    return states, jt


def port_system(states):
    """The same chains as one batched port SystemState."""
    return convert.system_from_numpy(
        np.stack([np.asarray(s.position) for s in states]),
        np.stack([np.asarray(s.species) for s in states]),
        np.stack([np.asarray(s.box) for s in states]),
        [float(s.density) for s in states],
        [float(s.temperature) for s in states],
        [float(s.energy) for s in states],
        device="cpu",
    )


def port_cb_state(system, cbs):
    """The JAX package's per-chain CBStates as one batched port CBState."""
    fields = ("planes", "idx", "slot", "shift", "attempted", "accepted", "overflow", "skipped")
    return convert.cb_state_from_numpy(
        system, *(np.stack([np.asarray(getattr(cb, f)) for cb in cbs]) for f in fields)
    )


def reference_draws(key, d, R, C, inner, A):
    """The shift and draws build_hyper_sweep_fn makes from a chain's key."""
    dt = jnp.float64
    _, k_shift, k_rand = jax.random.split(key, 3)
    shift = jax.random.uniform(k_shift, (d,), dt)
    k_pick, _, k_delta, k_acc = jax.random.split(k_rand, 4)
    up = jax.random.uniform(k_pick, (R, C, inner, A), dt, maxval=1.0 - 1e-7)
    dl = jax.random.normal(k_delta, (R, C, inner, d, A), dt)
    ua = jax.random.uniform(k_acc, (R, C, inner, A), dt, minval=jnp.finfo(dt).tiny)
    return [np.asarray(x) for x in (shift, up, ua, dl)]


def test_rebin_matches_jax():
    states, jt = jax_chains(122, 2, seeds=[0, 1])
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, 122)
    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    assert TCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, 122) == tspec
    rng = np.random.default_rng(3)
    shift = rng.uniform(0.0, 1.0, (2, 2)) * np.asarray(states[0].box)
    sys_t = port_system(states)
    planes, idx, slot, ovf = TCB.rebin(sys_t, tspec, torch.tensor(shift))
    for k, st in enumerate(states):
        jp, ji, js, jo = JCB.rebin(st, spec, jnp.asarray(shift[k]))
        np.testing.assert_array_equal(planes[k].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(slot[k].numpy(), np.asarray(js))
        assert bool(ovf[k]) == bool(jo)
    pos = TCB.unbin_positions(planes, idx, 122, torch.tensor(shift), sys_t.box)
    np.testing.assert_allclose(pos.numpy(), sys_t.position.numpy(), rtol=0, atol=1e-12)
    # the JAX package's initial sampler state, carried across, equals the port's
    cb_t = TCB.init_cb_state(sys_t, tspec, seed=0, n_moves=1)
    cb_j = port_cb_state(sys_t, [JCB.init_cb_state(st, spec, seed=0, n_moves=1) for st in states])
    for f in ("shift", "planes", "idx", "slot", "attempted", "accepted", "overflow", "skipped"):
        assert torch.equal(getattr(cb_t, f), getattr(cb_j, f)), f


def _parity(n, d, inner, sweeps, seeds):
    """One hyper-sweep call on len(seeds) chains through both packages."""
    states, jt = jax_chains(n, d, seeds)
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, n)
    pool = (JMB.displacement(SIGMA),)
    fn = jax.jit(
        jax.vmap(
            JCB.build_hyper_sweep_fn(
                spec, jt, n, inner=inner, sweeps=sweeps, pool=pool,
                use_pallas=True, pallas_interpret=True,
            ),
            in_axes=(0, None),
        )
    )
    cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=1) for st, s in zip(states, seeds)]
    cb_j = jax.tree.map(lambda *x: jnp.stack(x), *cbs)
    out_j = fn(cb_j, JMB.init_pool_params(pool))

    C, A = 2**d, spec.n_active
    R = sweeps * max(1, -(-n // (A * inner * C)))
    draws = [reference_draws(cb.key, d, R, C, inner, A) for cb in cbs]
    shift, up, ua, dl = (torch.tensor(np.stack(x)) for x in zip(*draws))

    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    tpool = (TMB.displacement(SIGMA),)
    cb_t = port_cb_state(port_system(states), cbs)
    hs = TCB.build_hyper_sweep_fn(tspec, TT.KobAndersen(device="cpu"), n, inner=inner, sweeps=sweeps, pool=tpool)
    out_t = hs(cb_t, TMB.init_pool_params(tpool, device="cpu"), shift=shift, up=up, ua=ua, dl=dl)
    return out_j, out_t


def _assert_same(out_j, out_t):
    np.testing.assert_array_equal(out_t.attempted.numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted.numpy(), np.asarray(out_j.accepted))
    np.testing.assert_allclose(
        out_t.system.position.numpy(), np.asarray(out_j.system.position), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        out_t.system.energy.numpy(), np.asarray(out_j.system.energy), rtol=1e-9
    )
    np.testing.assert_array_equal(out_t.idx.numpy(), np.asarray(out_j.idx))
    np.testing.assert_array_equal(out_t.skipped.numpy(), np.asarray(out_j.skipped))
    assert int(out_t.accepted.sum()) > 10


def test_hyper_sweep_matches_jax_pallas_2d():
    """A 4x4 2D grid, inner 2, two chains: same counters, positions within
    1e-9 and energy within rtol 1e-9 of the Pallas interpret path."""
    out_j, out_t = _parity(n=122, d=2, inner=2, sweeps=1, seeds=[3, 4])
    assert TCB.make_cb_spec(np.asarray(out_t.system.box[0]), 2.5, 122).ncells == (4, 4)
    _assert_same(out_j, out_t)


@pytest.mark.slow
def test_hyper_sweep_matches_jax_pallas_3d():
    """The setup of tests/test_cb_pallas.py: 3D, N = 1300, inner 4."""
    out_j, out_t = _parity(n=1300, d=3, inner=4, sweeps=2, seeds=[3, 5])
    _assert_same(out_j, out_t)


def test_ledger_matches_dense_recompute():
    """After a few calls with the port's own draws, the booked energy equals
    a dense recompute by the port and by the JAX package."""
    states, jt = jax_chains(122, 2, seeds=[7, 8])
    tspec = TCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, 122)
    pool = (TMB.displacement(SIGMA),)
    params = TMB.init_pool_params(pool, device="cpu")
    table = TT.KobAndersen(device="cpu")
    cb = TCB.init_cb_state(port_system(states), tspec, seed=11, n_moves=1)
    hs = TCB.build_hyper_sweep_fn(tspec, table, 122, inner=2, sweeps=2, pool=pool)
    for _ in range(3):
        cb = hs(cb, params)
    st = cb.system
    assert int(cb.accepted.sum()) > 50 and not bool(cb.overflow.any())
    e_port = TE.total_energy_dense(st.position, st.species, st.box, table).numpy()
    np.testing.assert_allclose(st.energy.numpy(), e_port, rtol=1e-9, atol=1e-7)
    for k in range(2):
        e_jax = float(
            JE.total_energy_dense(
                jnp.asarray(st.position[k].numpy()), jnp.asarray(st.species[k].numpy()),
                jnp.asarray(st.box[k].numpy()), jt,
            )
        )
        np.testing.assert_allclose(float(st.energy[k]), e_jax, rtol=1e-9, atol=1e-7)
    # the payload stays consistent with the global positions
    pay = cb.planes[:, :2].permute(0, 2, 3, 1).numpy()  # [B, cells, cap, d]
    for k in range(2):
        mask = cb.idx[k].numpy() >= 0
        glob = (pay[k][mask] + cb.shift[k].numpy()) % st.box[k].numpy()
        np.testing.assert_allclose(glob, st.position[k].numpy()[cb.idx[k].numpy()[mask]], atol=1e-9)
        np.testing.assert_array_equal(np.sort(cb.idx[k].numpy()[mask]), np.arange(122))


def test_skip_on_overflow_identity_and_ledger():
    """A call whose binning overflows a bucket is the identity: positions and
    ledger unchanged, `skipped` bumped, no attempts booked; the next valid
    calls keep the ledger equal to a dense recompute."""
    states, jt = jax_chains(122, 2, seeds=[2])
    system = port_system(states)
    table = TT.KobAndersen(device="cpu")
    pool = (TMB.displacement(SIGMA),)
    params = TMB.init_pool_params(pool, device="cpu")
    spec0 = TCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, 122)
    spec_tiny = TCB.CBSpec(ncells=spec0.ncells, cap=2)
    fn_tiny = TCB.build_hyper_sweep_fn(spec_tiny, table, 122, inner=2, pool=pool)
    cb = TCB.init_cb_state(system, spec_tiny, seed=5, n_moves=1)
    for _ in range(3):
        cb = fn_tiny(cb, params)
    assert torch.equal(cb.system.position, system.position)
    assert torch.equal(cb.system.energy, system.energy)
    assert cb.skipped.tolist() == [3] and bool(cb.overflow[0])
    assert int(cb.attempted.sum()) == 0

    fn0 = TCB.build_hyper_sweep_fn(spec0, table, 122, inner=2, pool=pool)
    cb = fn0(TCB.init_cb_state(system, spec0, seed=6, n_moves=1), params)
    mid = cb.system
    cb_t = fn_tiny(TCB.init_cb_state(mid, spec_tiny, seed=7, n_moves=1), params)
    assert cb_t.skipped.tolist() == [1] and torch.equal(cb_t.system.position, mid.position)
    cb = fn0(TCB.init_cb_state(cb_t.system, spec0, seed=8, n_moves=1), params)
    assert cb.skipped.tolist() == [0] and int(cb.attempted.sum()) > 0
    st = cb.system
    e_ref = TE.total_energy_dense(st.position, st.species, st.box, table)
    np.testing.assert_allclose(st.energy.numpy(), e_ref.numpy(), rtol=1e-9, atol=1e-7)


def test_slot_schedule_matches_jax():
    pools = [
        (JMB.displacement(0.1),),
        (JMB.displacement(0.1, 0.7), JMB.displacement(0.2, 0.3)),
    ]
    for pool in pools:
        tpool = tuple(TMB.displacement(dict(m.params)["sigma"], m.probability) for m in pool)
        for C, inner in [(4, 2), (8, 3)]:
            np.testing.assert_array_equal(
                TCB._slot_schedule(tpool, C, inner), JCB._slot_schedule(pool, C, inner)
            )
        np.testing.assert_array_equal(
            TMB.pool_probabilities(tpool, device="cpu").numpy(),
            np.asarray(JMB.pool_probabilities(pool)),
        )


def test_two_move_pool_matches_jax():
    """Two Gaussian displacements with different widths: the per-slot sigma
    and the per-move counters follow the same static schedule."""
    states, jt = jax_chains(122, 2, seeds=[9])
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, 122)
    pool = (JMB.displacement(0.05, 0.6), JMB.displacement(0.2, 0.4))
    fn = jax.jit(
        JCB.build_hyper_sweep_fn(
            spec, jt, 122, inner=2, pool=pool, use_pallas=True, pallas_interpret=True
        )
    )
    cb = JCB.init_cb_state(states[0], spec, seed=9, n_moves=2)
    out_j = fn(cb, JMB.init_pool_params(pool))
    C, A = 4, spec.n_active
    R = max(1, -(-122 // (A * 2 * C)))
    shift, up, ua, dl = (torch.tensor(x)[None] for x in reference_draws(cb.key, 2, R, C, 2, A))
    tpool = (TMB.displacement(0.05, 0.6), TMB.displacement(0.2, 0.4))
    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    hs = TCB.build_hyper_sweep_fn(tspec, TT.KobAndersen(device="cpu"), 122, inner=2, pool=tpool)
    cb_t = TCB.init_cb_state(port_system(states), tspec, seed=0, n_moves=2)
    out_t = hs(cb_t, TMB.init_pool_params(tpool, device="cpu"), shift=shift, up=up, ua=ua, dl=dl)
    np.testing.assert_array_equal(out_t.attempted[0].numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted[0].numpy(), np.asarray(out_j.accepted))
    np.testing.assert_allclose(
        out_t.system.position[0].numpy(), np.asarray(out_j.system.position), atol=1e-9
    )


def test_unported_pools_raise():
    """Every pool the JAX package's checkerboard backend runs builds; the
    combinations it refuses (smart or swap moves on a molecular system, a
    flip on an atomic one) raise ValueError in both packages."""
    tspec = TCB.CBSpec((4, 4), 8)
    spec = JCB.CBSpec((4, 4), 8)
    table, jt = TT.KobAndersen(device="cpu"), JT.KobAndersen()
    smart = (TMB.displacement_smart(0.1), JMB.displacement_smart(0.1))
    swap = (TMB.discrete_swap(0, 1, 1.0), JMB.discrete_swap(0, 1, 1.0))
    bias = (
        TMB.discrete_swap(0, 1, 1.0, policy="energy_bias", theta1=0.5),
        JMB.discrete_swap(0, 1, 1.0, policy="energy_bias", theta1=0.5),
    )
    flip = (TMB.molecule_flip(1.0), JMB.molecule_flip(1.0))
    for (t_mv, j_mv), max_bonds, ok in [
        (smart, 0, True), (swap, 0, True), (bias, 0, True), (flip, 2, True),
        (smart, 2, False), (swap, 2, False), (bias, 2, False), (flip, 0, False),
    ]:
        builds = [
            lambda: TCB.build_hyper_sweep_fn(
                tspec, table, 100, pool=(TMB.displacement(0.1), t_mv), max_bonds=max_bonds
            ),
            lambda: JCB.build_hyper_sweep_fn(
                spec, jt, 100, pool=(JMB.displacement(0.1), j_mv), max_bonds=max_bonds
            ),
        ]
        for build in builds:
            if ok:
                assert callable(build())
            else:
                with pytest.raises(ValueError, match="does not support"):
                    build()

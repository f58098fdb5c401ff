"""The candidate compaction (trim) of the port's checkerboard hyper-sweep
against the JAX package's (tests/test_cb_trim.py's checks): the trimmed
sweep on injected draws, trimmed against untrimmed, the ledger, the
overflow-as-identity semantics and their `skipped` count, auto_trim_k, the
kernel's plain version on compacted lanes, and the engine's reading of
`list_parameters.trim`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import cb_cuda
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .test_torch_cb_moves import reference_draws
from .test_torch_checkerboard import jax_chains, port_cb_state, port_system

torch.set_num_threads(1)

N, D, INNER, TEMPERATURE, DENSITY = 122, 2, 2, 1.5, 1.0
TRIM_K = 128  # below the 8 * cap = 160 neighbour lanes, above any in-range count


def _pools(kind):
    if kind == "disp":
        return (JMB.displacement(0.1),), (TMB.displacement(0.1),)
    return (
        (JMB.displacement(0.1, 0.7), JMB.discrete_swap(0, 1, 0.3)),
        (TMB.displacement(0.1, 0.7), TMB.discrete_swap(0, 1, 0.3)),
    )


def _parity(kind, trim_k, seeds=(3, 4)):
    """One trimmed hyper-sweep call on two chains through both packages."""
    states, jt = jax_chains(N, D, seeds, density=DENSITY)
    states = [s.replace(temperature=jnp.asarray(TEMPERATURE)) for s in states]
    spec = JCB.make_cb_spec(np.asarray(states[0].box), jt.max_cutoff, N)
    assert spec.ncells == (4, 4) and 8 * spec.cap > TRIM_K
    pool_j, pool_t = _pools(kind)
    fn = jax.jit(jax.vmap(
        JCB.build_hyper_sweep_fn(spec, jt, N, inner=INNER, pool=pool_j, trim_k=trim_k), in_axes=(0, None)
    ))
    cbs = [JCB.init_cb_state(st, spec, seed=s, n_moves=len(pool_j)) for st, s in zip(states, seeds)]
    out_j = fn(jax.tree.map(lambda *x: jnp.stack(x), *cbs), JMB.init_pool_params(pool_j))
    C, A = 2**D, spec.n_active
    R = max(1, -(-N // (A * INNER * C)))
    with_up2 = kind != "disp"
    draws = [reference_draws(cb.key, D, R, C, INNER, A, with_up2) for cb in cbs]
    draws = {k: torch.tensor(np.stack([dr[k] for dr in draws])) for k in draws[0]}
    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    table = TT.KobAndersen(device="cpu")
    cb_t = port_cb_state(port_system(states), cbs)
    hs = TCB.build_hyper_sweep_fn(tspec, table, N, inner=INNER, pool=pool_t, trim_k=trim_k)
    out_t = hs(cb_t, TMB.init_pool_params(pool_t, device="cpu"), **draws)
    return out_j, out_t, cb_t, table


def _assert_same(out_j, out_t):
    np.testing.assert_array_equal(out_t.attempted.numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted.numpy(), np.asarray(out_j.accepted))
    np.testing.assert_array_equal(out_t.skipped.numpy(), np.asarray(out_j.skipped))
    np.testing.assert_array_equal(out_t.system.species.numpy(), np.asarray(out_j.system.species))
    np.testing.assert_allclose(out_t.system.position.numpy(), np.asarray(out_j.system.position), rtol=0, atol=1e-9)
    np.testing.assert_allclose(out_t.system.energy.numpy(), np.asarray(out_j.system.energy), rtol=1e-9)


@pytest.mark.parametrize("kind", ["disp", "disp+swap"])
def test_trimmed_hyper_sweep_matches_jax(kind):
    """Same counters, skips and species, positions within 1e-9 and energy
    within rtol 1e-9 of the JAX package's trimmed sweep; the ledger equals a
    dense recompute."""
    out_j, out_t, _, table = _parity(kind, TRIM_K)
    _assert_same(out_j, out_t)
    assert int(out_t.skipped.sum()) == 0 and (out_t.accepted > 0).all()
    st = out_t.system
    np.testing.assert_allclose(
        st.energy.numpy(), TE.total_energy_dense(st.position, st.species, st.box, table).numpy(), rtol=1e-9
    )


def test_trim_overflow_matches_jax():
    """trim_k = 50 overflows in some substeps and not in others (this
    system's largest in-range counts are 42 to 59): each overflowing substep
    is the identity for its chain and counts one skip, exactly as in the JAX
    package."""
    out_j, out_t, _, _ = _parity("disp", 50)
    _assert_same(out_j, out_t)
    assert 0 < int(out_t.skipped.sum()) < 32, out_t.skipped  # 2 chains x 4 rounds x 4 colours
    assert int(out_t.accepted.sum()) > 0


def _liquid(n=300, seed=0, chains=2):
    """tests/test_cb_trim.py's start in 2D: jittered lattices of KA at
    rho 1.2 (deliberately close, so that energy changes are large)."""
    from .test_torch_inputs import lattice

    pos = np.stack([lattice(n, D, 1.2, seed + b)[0] for b in range(chains)])
    sp = np.stack([lattice(n, D, 1.2, seed + b)[1] for b in range(chains)])
    table = TT.KobAndersen(device="cpu")
    from particlesmc_tpu_torch.core.state import make_system

    st = TE.initialize_energy(make_system(pos, sp, 1.2, 1.0, device="cpu"), table, check=False)
    return st, table


def _run(st, table, pool, trim_k, calls=3, inner=3, seed=7):
    spec = TCB.make_cb_spec(st.box[0].numpy(), table.max_cutoff, st.n_particles)
    hs = TCB.build_hyper_sweep_fn(spec, table, st.n_particles, inner=inner, pool=pool, trim_k=trim_k)
    cb = TCB.init_cb_state(st, spec, seed, n_moves=len(pool))
    params = TMB.init_pool_params(pool, device="cpu")
    for _ in range(calls):
        cb = hs(cb, params)
    return cb, spec


@pytest.mark.parametrize("swap", [False, True], ids=["disp", "disp+swap"])
def test_trim_matches_untrimmed(swap):
    """On the same generator the trimmed and untrimmed sweeps take the same
    decisions: same counters and species, positions within 1e-12; the
    trimmed ledger equals a dense recompute."""
    st, table = _liquid()
    pool = (TMB.displacement(0.06, 0.8), TMB.discrete_swap(0, 1, 0.2)) if swap else (TMB.displacement(0.06),)
    a, spec = _run(st, table, pool, None)
    trim_k = 4 * spec.cap
    assert trim_k < 8 * spec.cap
    b, _ = _run(st, table, pool, trim_k)
    assert int(b.skipped.sum()) == 0
    assert torch.equal(a.attempted, b.attempted) and torch.equal(a.accepted, b.accepted)
    assert torch.equal(a.system.species, b.system.species)
    np.testing.assert_allclose(b.system.position.numpy(), a.system.position.numpy(), rtol=0, atol=1e-12)
    assert int(b.accepted.sum()) > 0
    s = b.system
    np.testing.assert_allclose(
        s.energy.numpy(), TE.total_energy_dense(s.position, s.species, s.box, table).numpy(), rtol=1e-9, atol=1e-7
    )


def test_trim_overflow_substep_is_identity():
    """trim_k = 2 always overflows: every substep is the identity, nothing
    is attempted or accepted, and every substep counts one skip."""
    st, table = _liquid()
    pool = (TMB.displacement(0.06),)
    cb, spec = _run(st, table, pool, trim_k=2, calls=2)
    rounds = max(1, -(-st.n_particles // (spec.n_active * 3 * 4)))
    assert cb.skipped.tolist() == [2 * rounds * 4] * 2
    assert int(cb.accepted.sum()) == 0 and int(cb.attempted.sum()) == 0
    assert torch.equal(cb.system.energy, st.energy)
    # positions only go through the shifted frame and back
    np.testing.assert_allclose(cb.system.position.numpy(), st.position.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "n,d,density,cap",
    [(10_000, 3, 1.2, 32), (1500, 3, 1.2, 16), (1500, 3, 1.2, None), (4096, 2, 1.2, None), (300, 2, 1.2, 40)],
)
def test_auto_trim_k_matches_jax(n, d, density, cap):
    """auto_trim_k equals the JAX package's (512 at the N = 10,000 main
    path's shape; None where compaction cannot beat (3^d - 1) * cap)."""
    box = np.full(d, (n / density) ** (1 / d))
    spec = JCB.make_cb_spec(box, 2.5, n, cap=cap)
    tspec = TCB.make_cb_spec(box, 2.5, n, cap=cap)
    assert tspec == TCB.CBSpec(spec.ncells, spec.cap)
    k = TCB.auto_trim_k(tspec, box, 2.5, n)
    assert k == JCB.auto_trim_k(spec, box, 2.5, n)
    if (n, cap) == (10_000, 32):
        assert k == 512
    if (n, cap) == (1500, 16):
        assert k is None


def test_plain_version_on_compacted_lanes():
    """disp_substep_plain with cap= on lanes LP = cap + K (the valid
    neighbour lanes moved to the front, then empty ones) takes the same
    decisions as on the uncompacted 3^d * cap lanes: same accepts,
    positions and booked energies within 1e-12. The kernel's wrapper checks
    cap= on the CPU as on the card."""
    st, table = _liquid(n=600)
    spec = TCB.make_cb_spec(st.box[0].numpy(), table.max_cutoff, st.n_particles)
    g = torch.Generator().manual_seed(5)
    B, d, A, cap, inner = st.n_chains, D, spec.n_active, spec.cap, 6
    planes, _, _, _ = TCB.rebin(st, spec, torch.rand((B, d), generator=g, dtype=torch.float64) * st.box)
    padded = TCB.pad_grid(planes, spec, st.box)
    pos, sp, _ = TCB.extract_colour(padded, spec, (1, 0))
    lo, hi = TCB.cell_bounds(spec, st.box[0], (1, 0))
    up = torch.rand((B, inner, A), generator=g, dtype=torch.float64) * (1 - 1e-7)
    dl = torch.randn((B, inner, d, A), generator=g, dtype=torch.float64) * 0.1
    thr = -torch.log(torch.rand((B, inner, A), generator=g, dtype=torch.float64))
    tab = cb_cuda.pack_table(table, torch.float64)
    full = cb_cuda.disp_substep_plain(pos, sp, up, dl, thr, lo, hi, tab)
    valid = sp[..., cap:] >= 0
    K = int(valid.sum(-1).max()) + 5
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[..., :K] + cap
    idx = torch.cat([torch.arange(cap).expand(B, A, cap), order], dim=-1)
    keep = torch.gather(sp, -1, idx) >= 0
    pos_c = torch.gather(pos, -1, idx[:, None].expand(B, d, A, cap + K)).contiguous()
    sp_c = torch.where(keep, torch.gather(sp, -1, idx), -1.0).contiguous()
    comp = cb_cuda.disp_substep(pos_c, sp_c, up, dl, thr, lo, hi, tab, kinds=TT.kinds_present(table), cap=cap)
    assert torch.equal(full[2], comp[2]) and int(full[2].sum()) > 0
    np.testing.assert_allclose(comp[0].numpy(), full[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(comp[1].numpy(), full[1].numpy(), rtol=0, atol=1e-12)
    assert cb_cuda._lanes(27 * 8, 3) == 8 and cb_cuda._lanes(cap + K, 2, cap) == cap
    for bad in (lambda: cb_cuda._lanes(100, 3), lambda: cb_cuda._lanes(10, 2, 11), lambda: cb_cuda._lanes(10, 2, 0)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize(
    "trim,want",
    [(False, None), (0, None), ("0", None), ("off", None), ("false", None), (None, None),
     (True, "auto"), ("auto", "auto"), ("true", "auto"), (1, "auto"), (96, 96), (10_000, 10_000)],
)
def test_engine_reads_trim_as_jax(trim, want):
    """list_parameters.trim as the JAX engine reads it: off, "auto"
    (auto_trim_k), or a lane count; 1 == True reads as "auto", as there; a
    count that cannot beat the uncompacted lanes turns compaction off."""
    st, table = _liquid(n=1600, chains=1)
    params = {"inner": 2, "cap": 40, "trim": trim}
    chains = Chains(states=st, table=table, list_type="cell", list_parameters=params, n_chains=1)
    sim = Simulation(chains, [dict(algorithm="Metropolis", pool=(TMB.displacement(0.05),), parallel_moves=True)], 1,
                     path="unused")
    spec = sim.cb_spec
    auto = TCB.auto_trim_k(spec, st.box[0].numpy(), table.max_cutoff, st.n_particles)
    assert auto is not None and auto < 8 * spec.cap
    assert sim.trim_k == (auto if want == "auto" else want)
    plan = sim._block(sim.rebin_every).plan
    assert plan.trim_k == (None if want in (None, 10_000) else sim.trim_k)  # 10,000 >= 8 * cap: off

"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the CUDA kernel against its plain version, the main path on the card
against the same path on the CPU, the sequential kernel, a replica-exchange
pass and the PGMC estimator on the card against the CPU, and bitwise resume
from a checkpoint on the card. Run on a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks;
this file and the modules it imports need only torch and numpy.)
"""

import numpy as np
import pytest
import torch

from particlesmc_tpu_torch.core import neighbours as NB
from particlesmc_tpu_torch.core.state import make_system, mol_table
from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
from particlesmc_tpu_torch.engine.tempering import replica_exchange
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as MB
from particlesmc_tpu_torch.moves import cb_cuda
from particlesmc_tpu_torch.moves import checkerboard as CB
from particlesmc_tpu_torch.moves import kernel as K

from .test_torch_inputs import ka2d, lattice, make_inputs, mixed_table, trimer_melt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (d, cap, model, A, inner): the first three at 8 cells and 3 sub-moves; then
# a ragged last block (A = 7 is not a multiple of the 4 cells of a block), the
# CLI path's cap and inner (2D, cap 23, inner 8), a full 32-lane centre cell
# with 48 sub-moves, a table with every kind and a kind-0 pair, and the
# lj-mixture swap path's cap of 192 centre lanes (more than a warp)
KERNEL_CASES = [
    (2, 6, "JBB", 8, 3),
    (3, 4, "KobAndersen", 8, 3),
    (3, 32, "BHHP", 8, 3),
    (3, 4, "KobAndersen", 7, 3),
    (2, 23, "JBB", 36, 8),
    (3, 32, "KobAndersen", 8, 48),
    (3, 6, "mixed", 7, 8),
    (3, 192, "KobAndersen", 8, 8),
]


@pytest.mark.parametrize("d,cap,model,A,inner", KERNEL_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kinds_given", [True, False])
def test_kernel_matches_plain(cuda, d, cap, model, A, inner, dtype, kinds_given):
    table = mixed_table(dtype, cuda) if model == "mixed" else getattr(TT, model)(dtype, cuda)
    args = [
        torch.tensor(x, dtype=dtype, device=cuda)
        for x in make_inputs(d, cap, inner, table.n_species, chains=3, A=A, seed=cap)
    ] + [cb_cuda.pack_table(table, dtype)]
    kinds = TT.kinds_present(table) if kinds_given else None
    launches = cb_cuda.disp_substep.launches
    k_pos, k_booked, k_acc = cb_cuda.disp_substep(*args, kinds=kinds)
    assert cb_cuda.disp_substep.launches == launches + 1
    p_pos, p_booked, p_acc = cb_cuda.disp_substep_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    same = (k_acc == p_acc).all(dim=-1)  # [B, A]
    if dtype == torch.float64:
        assert bool(same.all())
    else:  # summation order may flip an accept on a float32 boundary
        assert float(same.float().mean()) >= 0.9
    diff = (k_pos - p_pos).abs().amax(dim=(1, 3))
    assert float(torch.where(same, diff, torch.zeros_like(diff)).max()) <= tol
    booked_gap = torch.where(same, (k_booked - p_booked).abs(), torch.zeros_like(k_booked))
    assert float(booked_gap.max()) <= 1e3 * tol * (1 + float(p_booked.abs().max()))
    assert int(k_acc.sum()) > 0
    assert int(k_acc[:, A - 1].sum()) == 0  # the empty cell never accepts


def test_launch_plan_and_refusals(cuda):
    """The launcher packs 4 cells per block at the main path's shapes; a cell
    whose lanes do not fit in shared memory, and a potential variant the
    kernel does not have, raise instead of running."""
    for dtype in (torch.float32, torch.float64):
        cpb, smem = cb_cuda.launch_plan(dtype, 3, 2, 864, 48)
        assert cpb == 4 and smem <= 232448
    d, cap, inner = 3, 400, 2  # 10,800 lanes: one cell needs ~260 KB at f64
    args = [
        torch.tensor(x, device=cuda)
        for x in make_inputs(d, cap, inner, 2, chains=1, A=1, seed=0)
    ] + [cb_cuda.pack_table(TT.KobAndersen(torch.float64, cuda), torch.float64)]
    launches = cb_cuda.disp_substep.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        cb_cuda.disp_substep(*args)
    args = [
        torch.tensor(x, device=cuda) for x in make_inputs(2, 4, 2, 2, chains=1, A=4, seed=0)
    ] + [cb_cuda.pack_table(TT.KobAndersen(torch.float64, cuda), torch.float64)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(cb_cuda._KIND_VARIANTS, (TT.KIND_LENNARD_JONES,), 7)
        with pytest.raises(RuntimeError, match="variant"):
            cb_cuda.disp_substep(*args, kinds=(TT.KIND_LENNARD_JONES,))
    assert cb_cuda.disp_substep.launches == launches


POOLS = {
    "gaussian": (MB.displacement(0.08),),
    # the kernel's runs split by swap, EnergyBias and smart slots
    "mixed": (
        MB.displacement(0.08, 0.6),
        MB.discrete_swap(0, 1, 0.15),
        MB.discrete_swap(0, 1, 0.15, policy="energy_bias", theta1=0.5, theta2=-0.3),
        MB.displacement_smart(0.08, 0.1),
    ),
}


@pytest.mark.parametrize("pool_name", sorted(POOLS))
def test_hyper_sweep_cuda_matches_cpu(cuda, pool_name):
    """The checkerboard path on the card against the same path on the CPU
    (plain version), with injected draws: same counters and species,
    positions within 1e-9; the kernel launches once per run of Gaussian
    slots of each colour."""
    n, d = 300, 2
    pos, sp = lattice(n, d, 1.2, seed=1)
    pool = POOLS[pool_name]
    swaps = any(m.action == "swap" for m in pool)
    out, launches = {}, {}
    for dev in (torch.device("cpu"), cuda):
        table = TT.KobAndersen(torch.float64, dev)
        st = initialize_energy(make_system(pos, sp, 1.2, 1.0, device=dev).repeat(2), table)
        spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, n)
        hs = CB.build_hyper_sweep_fn(spec, table, n, inner=4, sweeps=2, pool=pool)
        g = np.random.default_rng(0)
        C, A = 2**d, spec.n_active
        R = 2 * max(1, -(-n // (A * 4 * C)))
        draws = dict(
            shift=g.uniform(0, 1, (2, d)),
            up=g.uniform(0, 1 - 1e-7, (2, R, C, 4, A)),
            ua=g.uniform(1e-300, 1, (2, R, C, 4, A)),
            dl=g.normal(0, 1, (2, R, C, 4, d, A)),
        )
        if swaps:
            draws["up2"] = g.uniform(0, 1 - 1e-7, (2, R, C, 4, A))
        cb = CB.init_cb_state(st, spec, seed=0, n_moves=len(pool))
        before = cb_cuda.disp_substep.launches
        out[dev.type] = hs(cb, MB.init_pool_params(pool, device=dev),
                           **{k: torch.tensor(v, device=dev) for k, v in draws.items()})
        launches[dev.type] = cb_cuda.disp_substep.launches - before
        runs = sum(
            seg[2] for ci in range(C)
            for seg in CB.schedule_segments(CB._slot_schedule(pool, C, 4)[ci], pool, kernel=True)
        )
    assert launches == {"cpu": 0, "cuda": R * runs}
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a.attempted, b.attempted.cpu())
    assert torch.equal(a.accepted, b.accepted.cpu())
    assert torch.equal(a.system.species, b.system.species.cpu())
    assert int(a.accepted.sum()) > 0
    np.testing.assert_allclose(b.system.position.cpu().numpy(), a.system.position.numpy(), atol=1e-9)
    np.testing.assert_allclose(b.system.energy.cpu().numpy(), a.system.energy.numpy(), rtol=1e-9)
    st = b.system
    e = total_energy_dense(st.position, st.species, st.box, TT.KobAndersen(torch.float64, cuda))
    np.testing.assert_allclose(st.energy.cpu().numpy(), e.cpu().numpy(), rtol=1e-9, atol=1e-7)


# (system, pool) of the sequential cases: KA 3D N = 216 at rho 0.5 (a 3^3
# grid with the cell list), and a trimer melt with MoleculeFlip
SEQ_CASES = ("dense", "cells", "flip")


def _sequential(case, dev):
    """The case's state on `dev` (3 chains), its kernel config and pool."""
    if case == "flip":
        pos, sp, mol, bonds = trimer_melt(27, 0.4, seed=2)
        table = TT.Trimer(torch.float64, dev)
        st = make_system(pos, sp, 0.4, 2.0, molecule=mol, bonds=bonds, device=dev)
        ms, ml = mol_table(mol - 1)
        pool = (MB.displacement(0.05, 0.6), MB.molecule_flip(0.4))
        config = K.KernelConfig(pool=pool, table=table, cell_spec=None, mol_start=tuple(ms), mol_len=tuple(ml))
    else:
        pos, sp = lattice(216, 3, 0.5, seed=4)
        table = TT.KobAndersen(torch.float64, dev)
        st = make_system(pos, sp, 0.5, 2.0, device=dev)
        pool = (MB.displacement(0.1, 0.5), MB.discrete_swap(0, 1, 0.3),
                MB.discrete_swap(0, 1, 0.2, policy="energy_bias", theta1=0.5, theta2=-0.3))
        spec = NB.make_spec(st.box[0].cpu().numpy(), table.max_cutoff, 216) if case == "cells" else None
        config = K.KernelConfig(pool=pool, table=table, cell_spec=spec)
    st = initialize_energy(st, table).repeat(3)
    return st, config, pool


def _seq_draws(case, n, steps, rounds):
    """Draws from a numpy seed; the swaps' ranks stay within the smallest
    population of the KA lattice (species 2, 20% of 216)."""
    g = np.random.default_rng(7)
    n_moves = 2 if case == "flip" else 3
    draws = dict(
        move=g.integers(0, n_moves, (3, steps)), i=g.integers(0, n, (3, steps)),
        normal=g.normal(0, 1, (3, steps, 3)), u=g.uniform(1e-300, 1, (3, steps)),
    )
    if case == "flip":
        m = g.integers(0, n // 3, (3, steps, rounds))
        draws["flip"] = np.stack([m, g.integers(0, 3, m.shape), g.integers(0, 2, m.shape)], -1)
    else:
        draws["r1"], draws["r2"] = g.integers(0, 30, (3, steps)), g.integers(0, 30, (3, steps))
        draws["gumbel"] = -np.log(-np.log(g.uniform(1e-300, 1, (3, steps, 2, n))))
    return draws


@pytest.mark.parametrize("case", SEQ_CASES)
def test_sequential_sweep_cuda_matches_cpu(cuda, case):
    """One sequential sweep on the card against the CPU on the same injected
    draws (dense, cell list, molecular flip): same counters and species,
    positions within 1e-9, energy within rtol 1e-9, equal cell lists; then a
    sweep on the state's own generator issues no host synchronisation."""
    out = {}
    for dev in (torch.device("cpu"), cuda):
        st, config, pool = _sequential(case, dev)
        mc = K.init_mc_state(st, config, 0)
        n = st.n_particles
        draws = _seq_draws(case, n, n, mc.flip_rounds)
        sweep = K.build_sweep_fn(config, n)
        params = MB.init_pool_params(pool, torch.float64, dev)
        out[dev.type] = sweep(mc, params, {k: torch.tensor(v, device=dev) for k, v in draws.items()})
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a.attempted, b.attempted.cpu()) and torch.equal(a.accepted, b.accepted.cpu())
    assert torch.equal(a.system.species, b.system.species.cpu())
    assert int(a.accepted.sum()) > 0
    np.testing.assert_allclose(b.system.position.cpu().numpy(), a.system.position.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.system.energy.cpu().numpy(), a.system.energy.numpy(), rtol=1e-9)
    if case == "cells":
        for f in ("bucket", "count", "cell_of", "overflow"):
            assert torch.equal(getattr(a.cell, f), getattr(b.cell, f).cpu()), f
    K.check_state(b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = sweep(b, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    K.check_state(b)
    s = b.system
    e = total_energy_dense(s.position, s.species, s.box, config.table, s.bonds)
    np.testing.assert_allclose(s.energy.cpu().numpy(), e.cpu().numpy(), rtol=1e-9)


def test_replica_exchange_cuda_matches_cpu(cuda):
    """A replica-exchange pass on a card state (with its cell list) against
    the same pass on the CPU, on the same uniforms; then a pass from the
    generator on the card."""
    out = []
    for dev in (torch.device("cpu"), cuda):
        st, config, _ = _sequential("cells", dev)
        st = st.replace(temperature=torch.tensor([0.8, 1.0, 1.3], dtype=torch.float64, device=dev),
                                  energy=st.energy + torch.tensor([5.0, -5.0, 0.0], dtype=torch.float64, device=dev))
        mc = K.init_mc_state(st, config, 0)
        out.append(replica_exchange(mc, 0, u=torch.full((3,), 0.5, dtype=torch.float64, device=dev)))
    (a, att_a, acc_a), (b, att_b, acc_b) = out
    assert acc_a.tolist() == acc_b.cpu().tolist() == [True, False, False]
    assert torch.equal(a.system.position, b.system.position.cpu())
    assert torch.equal(a.cell.bucket, b.cell.bucket.cpu())
    assert b.system.temperature.cpu().tolist() == [0.8, 1.0, 1.3]
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    c, att, _ = replica_exchange(b, 1, generator=g)
    assert c.system.position.is_cuda and att.cpu().tolist() == [False, True, False]


def _pgmc_sim(dev, path):
    """The reference PGMC scenario (N = 43 2D JBB, 2 chains, float64) with
    Displacement + an EnergyBias swap at θ ≠ 0 and an estimator of 5
    samples per chain, on `dev`."""
    from particlesmc_tpu_torch.engine.pgmc import BLANPG, VPG
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io.loader import Chains

    pos, sp, rho = ka2d(2)
    table = TT.JBB(torch.float64, dev)
    st = initialize_energy(make_system(pos, sp, rho, 0.5, device=dev), table)
    pool = (MB.displacement(0.08, 0.8), MB.discrete_swap(0, 2, 0.2, policy="energy_bias", theta1=0.3, theta2=-0.2))
    algos = [dict(algorithm="Metropolis", pool=pool, seed=3),
             dict(algorithm="PolicyGradientEstimator", optimisers=(VPG(1e-3), BLANPG(1e-4, 1e-6)), q_batch_size=5)]
    return Simulation(Chains(states=st, table=table, list_type="dense", n_chains=2), algos, 1, path=str(path))


def test_pgmc_estimate_cuda_matches_cpu(cuda, tmp_path):
    """Each chain's (g, F) of both learnable moves on the card equals the
    CPU's on the same fed-in actions within 1e-9 relative; estimate() from
    the estimator's own generator issues no host synchronisation."""
    cpu, card = _pgmc_sim(torch.device("cpu"), tmp_path / "a"), _pgmc_sim(cuda, tmp_path / "b")
    gen = torch.Generator().manual_seed(5)
    for m in (0, 1):
        prop = cpu._pgmc.sample_prop(cpu.pool_params[m], m, gen, cpu.mc.system, None, 5)
        ref = cpu._pgmc.per_chain(m, prop)
        out = card._pgmc.per_chain(m, K.Action(*(t.to(cuda) for t in prop)))
        for a, b in zip(ref, out):
            assert b.is_cuda and float(a.abs().max()) > 0
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-9, atol=1e-12 * float(a.abs().max()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card._pgmc.estimate()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(a is not None for a in card._pgmc._acc)
    card._pgmc.update()
    assert torch.isfinite(card.pool_params[1]["theta1"]).item()


@pytest.mark.parametrize("backend", ["sequential", "checkerboard"])
def test_resume_bitwise_cuda(cuda, tmp_path, backend):
    """On the card, a run resumed from its mid-run StoreCheckpoints file ends
    bitwise where the straight-through run ends (positions, species,
    energies, counters); the card's checkpoint does not load on the CPU."""
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io import checkpoint as CKPT
    from particlesmc_tpu_torch.io.loader import Chains

    cb = backend == "checkerboard"
    n = 140 if cb else 48
    pos, sp = lattice(n, 2, 0.5, seed=3)
    table = TT.KobAndersen(torch.float64, cuda)
    pool = (MB.displacement(0.1, 0.7), MB.discrete_swap(0, 1, 0.3))
    metro = dict(algorithm="Metropolis", pool=pool, seed=3, parallel_moves=cb)

    def sim(resume=None):
        st = initialize_energy(make_system(pos, sp, 0.5, 1.2, device=cuda), table).repeat(2)
        chains = Chains(states=st, table=table, list_type="dense", n_chains=2,
                        list_parameters={"inner": 2, "rebin_every": 2} if cb else {})
        return Simulation(chains, [metro, dict(algorithm="StoreCheckpoints", scheduler=[4], history=True)], 8,
                          path=str(tmp_path), resume=resume)

    a = sim().run()
    ckpt = str(tmp_path / "checkpoint_4.npz")
    b = sim(ckpt).run()
    for f in ("position", "species", "energy"):
        assert torch.equal(getattr(a.mc.system, f), getattr(b.mc.system, f)), f
    assert torch.equal(a.mc.attempted, b.mc.attempted) and torch.equal(a.mc.accepted, b.mc.accepted)
    assert a.mc.system.position.is_cuda and int(a.mc.accepted.sum()) > 0
    with pytest.raises(ValueError, match="cuda generator state .* cpu device"):
        if cb:
            CKPT.load_checkpoint_checkerboard(ckpt, a.cb_spec, device="cpu")
        else:
            CKPT.load_checkpoint(ckpt, a.config, device="cpu")


@pytest.mark.parametrize("pool_name", sorted(POOLS))
def test_trimmed_hyper_sweep_cuda_matches_cpu(cuda, pool_name):
    """The trimmed checkerboard path (LP = cap + trim_k lanes) on the card
    against the same path on the CPU, with injected draws: same counters,
    skips and species, positions within 1e-9; the kernel launches once per
    run of Gaussian slots of each colour, as untrimmed."""
    n, d = 600, 2
    pos, sp = lattice(n, d, 1.2, seed=2)
    pool = POOLS[pool_name]
    out, launches = {}, {}
    for dev in (torch.device("cpu"), cuda):
        table = TT.KobAndersen(torch.float64, dev)
        st = initialize_energy(make_system(pos, sp, 1.2, 1.0, device=dev).repeat(2), table)
        spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, n)
        trim_k = 4 * spec.cap
        hs = CB.build_hyper_sweep_fn(spec, table, n, inner=4, pool=pool, trim_k=trim_k)
        assert hs.plan.trim_k == trim_k
        g = np.random.default_rng(1)
        C, A = 2**d, spec.n_active
        R = max(1, -(-n // (A * 4 * C)))
        draws = dict(shift=g.uniform(0, 1, (2, d)), up=g.uniform(0, 1 - 1e-7, (2, R, C, 4, A)),
                     ua=g.uniform(1e-300, 1, (2, R, C, 4, A)), dl=g.normal(0, 1, (2, R, C, 4, d, A)))
        if any(m.action == "swap" for m in pool):
            draws["up2"] = g.uniform(0, 1 - 1e-7, (2, R, C, 4, A))
        before = cb_cuda.disp_substep.launches
        out[dev.type] = hs(CB.init_cb_state(st, spec, seed=0, n_moves=len(pool)), MB.init_pool_params(pool, device=dev),
                           **{k: torch.tensor(v, device=dev) for k, v in draws.items()})
        launches[dev.type] = cb_cuda.disp_substep.launches - before
        runs = sum(seg[2] for segs in hs.plan.segments for seg in segs)
    assert launches == {"cpu": 0, "cuda": R * runs}
    a, b = out["cpu"], out["cuda"]
    for f in ("attempted", "accepted", "skipped"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    assert torch.equal(a.system.species, b.system.species.cpu()) and int(a.accepted.sum()) > 0
    np.testing.assert_allclose(b.system.position.cpu().numpy(), a.system.position.numpy(), atol=1e-9)
    np.testing.assert_allclose(b.system.energy.cpu().numpy(), a.system.energy.numpy(), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,cap,K", [(3, 32, 512), (3, 4, 37), (2, 23, 100)])
def test_kernel_with_cap_matches_plain(cuda, dtype, d, cap, K):
    """The kernel with cap= on LP = cap + K lanes (the valid neighbour lanes
    compacted to the front, K not a multiple of 3^d) against its plain
    version on the same lanes and against the untrimmed plain version."""
    table = TT.KobAndersen(dtype, cuda)
    x = make_inputs(d, cap, 8, 2, chains=3, A=7, seed=cap)
    pos, sp = (torch.tensor(v, dtype=dtype, device=cuda) for v in x[:2])
    rest = [torch.tensor(v, dtype=dtype, device=cuda) for v in x[2:]] + [cb_cuda.pack_table(table, dtype)]
    B, _, A, LP = pos.shape
    valid = sp[..., cap:] >= 0
    K = max(K, int(valid.sum(-1).max()))
    # the valid lanes first, in order; the empty ones after them keep species -1
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[..., :K] + cap
    idx = torch.cat([torch.arange(cap, device=cuda).expand(B, A, cap), order], dim=-1)
    pos_c = torch.gather(pos, -1, idx[:, None].expand(B, d, A, cap + K)).contiguous()
    sp_c = torch.gather(sp, -1, idx).contiguous()
    k_out = cb_cuda.disp_substep(pos_c, sp_c, *rest, kinds=TT.kinds_present(table), cap=cap)
    p_out = cb_cuda.disp_substep_plain(pos_c, sp_c, *rest, cap=cap)
    full = cb_cuda.disp_substep_plain(pos, sp, *rest)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for ref in (p_out, full):
        same = (k_out[2] == ref[2]).all(dim=-1)
        assert bool(same.all()) if dtype == torch.float64 else float(same.float().mean()) >= 0.9
        diff = (k_out[0] - ref[0]).abs().amax(dim=(1, 3))
        assert float(torch.where(same, diff, torch.zeros_like(diff)).max()) <= tol
    assert int(k_out[2].sum()) > 0


def test_spatial_p2_cuda_matches_unsharded(cuda):
    """P = 2 slabs on one card (a device list repeating cuda:0) against the
    unsharded sweep on the card on the same generator: positions, species
    and counters bitwise in float64; the kernel launches once per slab per
    kernel run of each colour."""
    from particlesmc_tpu_torch.parallel import mesh as PM
    from particlesmc_tpu_torch.parallel import spatial as SP

    from .test_torch_inputs import wide_config

    pos, sp, box, rho = wide_config(seed=2)
    table = TT.KobAndersen(torch.float64, cuda)
    st = initialize_energy(make_system(pos, sp, rho, 5.0, box=box, device=cuda), table)
    spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, st.n_particles)
    pool = (MB.displacement(0.1, 0.8), MB.discrete_swap(0, 1, 0.2))
    params = MB.init_pool_params(pool, device=cuda)
    ref = CB.build_hyper_sweep_fn(spec, table, st.n_particles, inner=3, pool=pool)
    spat = SP.build_spatial_hyper_sweep_fn(spec, table, st.n_particles, PM.make_mesh(device=[cuda, cuda]),
                                           inner=3, pool=pool)
    out, launches = [], []
    for fn in (ref, spat):
        before = cb_cuda.disp_substep.launches
        out.append(fn(CB.init_cb_state(st, spec, seed=4, n_moves=2), params))
        launches.append(cb_cuda.disp_substep.launches - before)
    a, b = out
    assert launches[1] == 2 * launches[0] > 0
    assert torch.equal(a.system.position, b.system.position) and torch.equal(a.system.species, b.system.species)
    assert torch.equal(a.accepted, b.accepted) and int(a.accepted.sum()) > 0
    np.testing.assert_allclose(b.system.energy.cpu().numpy(), a.system.energy.cpu().numpy(), rtol=1e-12)


def test_pressure_cuda_matches_cpu(cuda):
    """The virial pressure on the card against the CPU, float64, on two KA
    chains."""
    from particlesmc_tpu_torch.core.energy import pressure

    pos, sp = lattice(500, 3, 1.2, seed=3)
    out = []
    for dev in (torch.device("cpu"), cuda):
        st = make_system(np.stack([pos, pos * 0.999]), np.stack([sp, sp]), 1.2, [1.0, 0.7], device=dev)
        table = TT.KobAndersen(torch.float64, dev)
        out.append(pressure(st.position, st.species, st.box, table, st.density, st.temperature).cpu())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=1e-9)


def test_analysis_numpy_input_runs_on_the_card(cuda, monkeypatch):
    """A numpy trajectory, as io/formats.read_trajectory gives it, goes to
    the card by default: g(r) counts and the MSD equal the CPU's."""
    from particlesmc_tpu_torch.analysis import structure as A

    seen = []
    to_f64 = A._f64

    def spy(x, device=None):
        out = to_f64(x, device)
        seen.append(out.device.type)
        return out

    monkeypatch.setattr(A, "_f64", spy)
    rng = np.random.default_rng(5)
    frames, box = rng.uniform(0.0, 6.0, (4, 300, 3)), np.full(3, 6.0)
    _, g_card = A.radial_distribution(frames, box, nbins=40, rmax=2.9)
    _, g_cpu = A.radial_distribution(frames, box, nbins=40, rmax=2.9, device="cpu")
    np.testing.assert_array_equal(g_card, g_cpu)
    msd_card = A.mean_squared_displacement(frames, box)
    np.testing.assert_allclose(msd_card, A.mean_squared_displacement(frames, box, device="cpu"), rtol=0, atol=1e-12)
    assert seen == ["cuda", "cpu", "cuda", "cpu"]

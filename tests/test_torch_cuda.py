"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the CUDA kernel against its plain version, and the main path on the card
against the same path on the CPU. Run on a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks;
this file and the modules it imports need only torch and numpy.)
"""

import numpy as np
import pytest
import torch

from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as MB
from particlesmc_tpu_torch.moves import cb_cuda
from particlesmc_tpu_torch.moves import checkerboard as CB

from .test_torch_inputs import lattice, make_inputs, mixed_table

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

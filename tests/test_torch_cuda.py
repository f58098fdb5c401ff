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

from .test_torch_inputs import lattice, make_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d,cap,model", [(2, 6, "JBB"), (3, 4, "KobAndersen"), (3, 32, "BHHP")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain(cuda, d, cap, model, dtype):
    table = getattr(TT, model)(dtype, cuda)
    args = [
        torch.tensor(x, dtype=dtype, device=cuda)
        for x in make_inputs(d, cap, 3, table.n_species, chains=3, A=8, seed=cap)
    ] + [cb_cuda.pack_table(table, dtype)]
    launches = cb_cuda.disp_substep.launches
    k_pos, k_booked, k_acc = cb_cuda.disp_substep(*args)
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


def test_hyper_sweep_cuda_matches_cpu(cuda):
    """The main path on the card against the same path on the CPU (plain
    version), with injected draws: same counters, positions within 1e-9."""
    n, d = 300, 2
    pos, sp = lattice(n, d, 1.2, seed=1)
    pool = (MB.displacement(0.08),)
    out = {}
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
        cb = CB.init_cb_state(st, spec, seed=0)
        out[dev.type] = hs(cb, MB.init_pool_params(pool, device=dev),
                           **{k: torch.tensor(v, device=dev) for k, v in draws.items()})
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a.attempted, b.attempted.cpu())
    assert torch.equal(a.accepted, b.accepted.cpu())
    np.testing.assert_allclose(b.system.position.cpu().numpy(), a.system.position.numpy(), atol=1e-9)
    np.testing.assert_allclose(b.system.energy.cpu().numpy(), a.system.energy.numpy(), rtol=1e-9)
    st = b.system
    e = total_energy_dense(st.position, st.species, st.box, TT.KobAndersen(torch.float64, cuda))
    np.testing.assert_allclose(st.energy.cpu().numpy(), e.cpu().numpy(), rtol=1e-9, atol=1e-7)

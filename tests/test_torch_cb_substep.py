"""The colour-substep function of the port (moves/cb_cuda.py) against the TPU
kernel it replaces, particlesmc_tpu/moves/cb_pallas.py::build_disp_substep,
run in Pallas interpret mode. On the CPU the port's wrapper runs its plain
version; the CUDA kernel is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.models import potentials as JP
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves.cb_pallas import build_disp_substep
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import cb_cuda

from .test_torch_inputs import make_inputs

torch.set_num_threads(1)

CASES = [(2, 6, "KobAndersen"), (2, 6, "JBB"), (3, 4, "KobAndersen"), (3, 4, "JBB")]


@pytest.mark.parametrize("d,cap,model", CASES)
def test_plain_substep_matches_pallas_interpret(d, cap, model):
    inner = 2
    jt = getattr(JT, model)()
    tt = getattr(TT, model)(device="cpu")
    pos, sp, up, dl, thr, lo, hi = make_inputs(d, cap, inner, tt.n_species, seed=d)
    A = lo.shape[1]

    kp = JT.kinds_present(jt)
    sub = build_disp_substep(
        jt, kp, JP.pair_fields_needed(kp), d=d, A=A, cap=cap, inner=inner, interpret=True
    )
    j_pos, j_booked, j_acc = jax.jit(jax.vmap(sub, in_axes=(0, 0, 0, 0, 0, None, None)))(
        *(jnp.asarray(x) for x in (pos, sp, up, dl, thr, lo, hi))
    )

    launches = cb_cuda.disp_substep.launches
    t = [torch.tensor(x) for x in (pos, sp, up, dl, thr, lo, hi)]
    centre, booked, acc = cb_cuda.disp_substep(*t, cb_cuda.pack_table(tt, torch.float64))
    assert cb_cuda.disp_substep.launches == launches  # CPU tensors never launch

    assert centre.shape == (2, d, A, cap) and acc.shape == (2, A, inner)
    np.testing.assert_array_equal(acc.sum(dim=1).numpy(), np.asarray(j_acc))
    np.testing.assert_allclose(centre.numpy(), np.asarray(j_pos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(booked.sum(dim=1).numpy(), np.asarray(j_booked), rtol=1e-12, atol=1e-12)
    assert int(acc.sum()) > 0
    assert int(acc[:, A - 1].sum()) == 0  # the empty cell never accepts


def test_wrapper_checks_inputs():
    d, cap, inner = 2, 3, 2
    pos, sp, up, dl, thr, lo, hi = make_inputs(d, cap, inner, 2)
    tab = cb_cuda.pack_table(TT.KobAndersen(device="cpu"), torch.float64)
    good = [torch.tensor(x) for x in (pos, sp, up, dl, thr, lo, hi)] + [tab]
    cb_cuda._check(*good)
    bad_dtype = list(good)
    bad_dtype[2] = bad_dtype[2].float()
    with pytest.raises(TypeError):
        cb_cuda._check(*bad_dtype)
    bad_shape = list(good)
    bad_shape[5] = bad_shape[5][:, :-1]
    with pytest.raises(ValueError):
        cb_cuda._check(*bad_shape)
    strided = list(good)
    strided[4] = strided[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cb_cuda._check(*strided)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cb_cuda.disp_substep(*[x.to("meta") for x in good])

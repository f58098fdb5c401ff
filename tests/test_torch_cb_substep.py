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
from particlesmc_tpu_torch import tracing
from particlesmc_tpu_torch.core.energy import initialize_energy
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import cb_cuda
from particlesmc_tpu_torch.moves import checkerboard as TCB

from .test_torch_inputs import lattice, make_inputs, mixed_table

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

    launches = tracing.counters().get("cb_cuda.launches", 0)
    t = [torch.tensor(x) for x in (pos, sp, up, dl, thr, lo, hi)]
    centre, booked, acc = cb_cuda.disp_substep(*t, cb_cuda.pack_table(tt, torch.float64))
    assert tracing.counters().get("cb_cuda.launches", 0) == launches  # CPU tensors never launch

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


def _table(model, dtype=torch.float64):
    if model == "mixed":
        return mixed_table(dtype, "cpu")
    return getattr(TT, model)(dtype, "cpu")


@pytest.mark.parametrize(
    "model,kinds,variant",
    [("KobAndersen", (2,), 2), ("JBB", (3,), 3), ("BHHP", (1,), 1), ("mixed", (0, 1, 2, 3), 0)],
)
def test_kernel_variant_of_each_table(model, kinds, variant):
    """Each canned model has one kind and gets that kind's variant; a table
    that mixes kinds (here with a kind-0 pair) gets the generic one. The
    packed table gives the same kinds as the PairTable."""
    table = _table(model)
    assert TT.kinds_present(table) == kinds
    assert cb_cuda.table_kinds(cb_cuda.pack_table(table, torch.float32)) == kinds
    assert cb_cuda.kernel_variant(kinds) == variant
    assert cb_cuda.kernel_variant(()) == cb_cuda.GENERIC_VARIANT


@pytest.mark.parametrize("d,cap,model", [(2, 6, "JBB"), (3, 4, "KobAndersen"), (3, 4, "mixed")])
def test_cpu_substep_with_kinds_is_the_plain_version(d, cap, model):
    """On CPU tensors `kinds=` changes nothing: the wrapper runs the plain
    version, and launches nothing."""
    table = _table(model)
    args = [torch.tensor(x) for x in make_inputs(d, cap, 3, table.n_species, A=5, seed=cap)]
    args.append(cb_cuda.pack_table(table, torch.float64))
    launches = tracing.counters().get("cb_cuda.launches", 0)
    got = cb_cuda.disp_substep(*args, kinds=TT.kinds_present(table))
    want = cb_cuda.disp_substep_plain(*args)
    assert tracing.counters().get("cb_cuda.launches", 0) == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


def test_hyper_sweep_reads_kinds_once(monkeypatch):
    """build_hyper_sweep_fn reads the table's kinds (a host sync) once, when
    it is built, and hands them to every launch."""
    n, d = 150, 2
    pos, sp = lattice(n, d, 1.2, seed=3)
    table = TT.KobAndersen(device="cpu")
    st = initialize_energy(make_system(pos, sp, 1.2, 1.0, device="cpu").repeat(2), table)
    spec = TCB.make_cb_spec(st.box[0].numpy(), table.max_cutoff, n)
    reads, seen = [], []

    def counting_kinds_present(t):
        reads.append(t)
        return TT.kinds_present(t)

    def recording_disp_substep(*args, kinds=None):
        seen.append(kinds)
        return cb_cuda.disp_substep(*args, kinds=kinds)

    monkeypatch.setattr(TCB, "kinds_present", counting_kinds_present)
    monkeypatch.setattr(TCB, "disp_substep", recording_disp_substep)
    pool = (TMB.displacement(0.08),)
    hs = TCB.build_hyper_sweep_fn(spec, table, n, inner=2, sweeps=2, pool=pool)
    cb = TCB.init_cb_state(st, spec, seed=0)
    params = TMB.init_pool_params(pool, device="cpu")
    for _ in range(2):
        cb = hs(cb, params)
    rounds = max(1, -(-n // (spec.n_active * 2 * 2**d)))
    assert len(reads) == 1
    assert len(seen) == 2 * 2 * rounds * 2**d  # calls x sweeps x rounds x colours
    assert set(seen) == {(TT.KIND_LENNARD_JONES,)}
    assert int(cb.accepted.sum()) > 0

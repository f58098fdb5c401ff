"""Parity of the port's pair tables and pair potential with the JAX package
(particlesmc_tpu_torch/models against particlesmc_tpu/models)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.models import potentials as JP
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu_torch import convert
from particlesmc_tpu_torch.models import potentials as TP
from particlesmc_tpu_torch.models import tables as TT

torch.set_num_threads(1)

SOFT_DICT = {
    "1-1": {"name": "SoftSpheres", "epsilon": 1.0, "sigma": 1.0, "n": 12},
    "1-2": {"name": "SoftSpheres", "epsilon": 1.0, "sigma": 1.2, "n": 9, "rcut": 2.9},
    "2-2": {"name": "SoftSpheres", "epsilon": 0.7, "sigma": 1.4, "n": 12},
}
MIXED_DICT = {
    "1-1": {"name": "LennardJones", "epsilon": 1.0, "sigma": 1.0},
    "1-2": {"name": "SoftSpheres", "epsilon": 1.0, "sigma": 0.9, "n": 12},
    "1-3": {"name": "SmoothLennardJones", "epsilon": 0.75, "sigma": 0.9},
    "2-2": {"name": "LennardJones", "epsilon": 0.5, "sigma": 0.88, "shift_potential": False},
    "2-3": {"name": "SoftSpheres", "epsilon": 2.0, "sigma": 1.0, "n": 9},
    "3-3": {"name": "SmoothLennardJones", "epsilon": 1.0, "sigma": 0.94},
}


KG_DICT = {
    "1-1": {"name": "GeneralKG", "epsilon": 1.0, "sigma": 1.0, "k": 0.0, "r0": 1.5},
    "1-2": {"name": "GeneralKG", "epsilon": 1.2, "sigma": 0.95, "k": 30.0, "r0": 1.5,
            "epsilonbond": 0.8, "sigmabond": 0.9, "rcutbond": 1.1},
    "2-2": {"name": "GeneralKG", "epsilon": 1.0, "sigma": 1.1, "k": 27.2, "r0": 1.6, "rcut": 1.3},
}


def _tables():
    """(name, JAX table, port table) for every model the port covers."""
    return [
        ("BHHP", JT.BHHP(), TT.BHHP(device="cpu")),
        ("KobAndersen", JT.KobAndersen(), TT.KobAndersen(device="cpu")),
        ("JBB", JT.JBB(), TT.JBB(device="cpu")),
        ("soft_dict", JT.model_matrix_from_dict(SOFT_DICT, 2), TT.model_matrix_from_dict(SOFT_DICT, 2, device="cpu")),
        ("mixed_dict", JT.model_matrix_from_dict(MIXED_DICT, 3), TT.model_matrix_from_dict(MIXED_DICT, 3, device="cpu")),
        ("Trimer", JT.Trimer(), TT.Trimer(device="cpu")),
        ("kg_dict", JT.model_matrix_from_dict(KG_DICT, 2), TT.model_matrix_from_dict(KG_DICT, 2, device="cpu")),
    ]


@pytest.mark.parametrize("case", range(7), ids=[t[0] for t in _tables()])
def test_pair_table_fields_equal(case):
    name, jt, tt = _tables()[case]
    for f in dataclasses.fields(TT.PairTable):
        a = np.asarray(getattr(jt, f.name))
        b = getattr(tt, f.name).numpy()
        assert a.dtype.kind == b.dtype.kind, f.name
        np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f.name}")
    # carried across as numpy arrays, the JAX table is the port's
    names = [f.name for f in dataclasses.fields(TT.PairTable)]
    tc = convert.table_from_numpy({f: np.asarray(getattr(jt, f)) for f in names}, device="cpu")
    for f in names:
        assert torch.equal(getattr(tc, f), getattr(tt, f)), f
    assert tt.n_species == jt.n_species
    assert tt.max_cutoff == jt.max_cutoff
    assert TT.kinds_present(tt) == JT.kinds_present(jt)
    assert TT.interaction_range(tt) == JT.interaction_range(jt)


def _assert_tables_equal(jt, tt):
    for f in dataclasses.fields(TT.PairTable):
        a = np.asarray(getattr(jt, f.name))
        b = getattr(tt, f.name).numpy()
        assert a.dtype.kind == b.dtype.kind, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_resolve_model_registry():
    # the port also names the reference's LJ-mixture validation table, which
    # the JAX package holds as [model."i-j"] blocks only (tests/test_torch_ljmix.py)
    assert set(TT.MODEL_REGISTRY) == set(JT.MODEL_REGISTRY) | {"BinaryLJMixture"}
    tt = TT.resolve_model("JBB()", 3, device="cpu")
    np.testing.assert_array_equal(tt.eps4.numpy(), np.asarray(JT.JBB().eps4))
    with pytest.raises(ValueError):
        TT.resolve_model("NoSuchModel", 2, device="cpu")
    # the molecular models resolve to the JAX package's tables
    for name in ("Trimer", "GeneralKG", "Trimer()"):
        _assert_tables_equal(JT.resolve_model(name, 3), TT.resolve_model(name, 3, device="cpu"))
    kg = {"name": "GeneralKG", "epsilon": 1.0, "sigma": 1.0, "k": 30.0, "r0": 1.5}
    _assert_tables_equal(
        JT.model_matrix_from_dict({"1-1": kg}, 1), TT.model_matrix_from_dict({"1-1": kg}, 1, device="cpu")
    )


def _kind_zero_table(mod, **kw):
    """3x3 table that holds all four kinds, kind 0 on the (0, 0) pair."""
    base = mod._base_entry()
    ss = mod.soft_spheres(1.0, 1.1, 12)
    lj = mod.lennard_jones(1.5, 0.8)
    sm = mod.smooth_lennard_jones(0.75, 0.9)
    entries = [[base, ss, lj], [ss, sm, lj], [lj, lj, ss]]
    return mod.build_pair_table(entries, **kw)


def _r2_grid(rcut2_values):
    r = np.linspace(0.3, 3.2, 301)
    extra = [0.0, 1e-13, 1e-12, 5e-12] + list(rcut2_values)
    return np.concatenate([r * r, np.asarray(extra)])


@pytest.mark.parametrize("table_name", ["kind_zero", "JBB", "KobAndersen", "BHHP", "mixed_dict"])
@pytest.mark.parametrize("pruned", [False, True])
def test_pair_potential_matches_jax(table_name, pruned):
    if table_name == "kind_zero":
        jt, tt = _kind_zero_table(JT), _kind_zero_table(TT, device="cpu")
    else:
        _, jt, tt = next(t for t in _tables() if t[0] == table_name)
    S = tt.n_species
    kp = TT.kinds_present(tt) if pruned else None
    r2 = _r2_grid(np.unique(tt.rcut2.numpy()))
    si, sj = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    si, sj = si.reshape(-1, 1), sj.reshape(-1, 1)
    pj = JT.gather_pair(jt, jnp.asarray(si), jnp.asarray(sj))
    uj = np.asarray(JP.pair_potential(jnp.asarray(r2)[None, :], pj, kp))
    pt = TT.gather_pair(tt, torch.tensor(si), torch.tensor(sj))
    ut = TP.pair_potential(torch.tensor(r2)[None, :], pt, kp).numpy()
    np.testing.assert_allclose(ut, uj, rtol=1e-13, atol=0.0)
    # r2 == rcut2 stays in range; kind 0 and r2 > rcut2 give exactly 0
    assert np.isfinite(ut).all()
    assert (ut[:, r2 > tt.rcut2.numpy().max()] == 0.0).all()


def _eval_pair(table, r, si=0, sj=0):
    p = TT.gather_pair(table, torch.tensor(si), torch.tensor(sj))
    return float(TP.pair_potential(torch.tensor(r * r, dtype=torch.float64), p))


def test_lennard_jones_closed_form():
    tab = TT.build_pair_table([[TT.lennard_jones(1.5, 0.8)]], device="cpu")
    r = 1.0
    sr6 = (0.8 / r) ** 12 - (0.8 / r) ** 6
    rc = 2.5 * 0.8
    shift = 4 * 1.5 * ((0.8 / rc) ** 12 - (0.8 / rc) ** 6)
    assert _eval_pair(tab, r) == pytest.approx(4 * 1.5 * sr6 - shift, rel=1e-12)
    assert _eval_pair(tab, rc) == pytest.approx(0.0, abs=1e-12)
    assert _eval_pair(tab, rc + 0.1) == 0.0


def test_lj_unshifted_option():
    tab = TT.build_pair_table([[TT.lennard_jones(1.0, 1.0, shift_potential=False)]], device="cpu")
    r = 2.4999
    assert _eval_pair(tab, r) == pytest.approx(4 * ((1 / r) ** 12 - (1 / r) ** 6), rel=1e-10)


@pytest.mark.parametrize("eps,sigma,n,r", [(1.0, 1.2, 12, 1.1), (2.0, 1.0, 9, 1.3)])
def test_soft_spheres_closed_form(eps, sigma, n, r):
    tab = TT.build_pair_table([[TT.soft_spheres(eps, sigma, n)]], device="cpu")
    rc = 2.5 * sigma
    expect = eps * (sigma / r) ** n - eps * (sigma / rc) ** n
    assert _eval_pair(tab, r) == pytest.approx(expect, rel=1e-12)


def test_smooth_lj_closed_form():
    eps, sig = 1.5, 0.8
    tab = TT.build_pair_table([[TT.smooth_lennard_jones(eps, sig)]], device="cpu")
    r2 = 1.0
    lj = 4 * eps * ((sig * sig / r2) ** 6 - (sig * sig / r2) ** 3)
    C0, C2, C4 = 0.04049023795, -0.00970155098, 0.00062012616
    smooth = 4 * eps * (C0 + C2 * r2 / sig**2 + C4 * r2 * r2 / sig**4)
    assert _eval_pair(tab, math.sqrt(r2)) == pytest.approx(lj + smooth, rel=1e-12)


def test_lj_and_inverse_power_match_jax():
    r2 = np.linspace(0.3, 3.2, 301) ** 2
    n = np.where(np.arange(r2.size) % 2 == 0, 12, 9)
    np.testing.assert_allclose(
        TP.lj_unshifted(torch.tensor(r2), 6.0, 0.64).numpy(),
        np.asarray(JP.lj_unshifted(jnp.asarray(r2), 6.0, 0.64)),
        rtol=1e-13, atol=0.0,
    )
    np.testing.assert_allclose(
        TP.inverse_power(torch.tensor(r2), 1.3, 1.21, torch.tensor(n, dtype=torch.int32)).numpy(),
        np.asarray(JP.inverse_power(jnp.asarray(r2), 1.3, 1.21, jnp.asarray(n, jnp.int32))),
        rtol=1e-13, atol=0.0,
    )


def test_pair_fields_needed_matches_jax():
    for kp in [None, (1,), (2,), (3,), (0, 2), (1, 2, 3), (0, 1, 2, 3)]:
        assert TP.pair_fields_needed(kp) == JP.pair_fields_needed(kp)


@pytest.mark.parametrize("table_name", ["kind_zero", "JBB", "BHHP", "mixed_dict", "Trimer"])
@pytest.mark.parametrize("pruned", [False, True])
def test_pair_virial_matches_jax(table_name, pruned):
    """The virial (the force of the smart move) on the r^2 grid of
    test_pair_potential_matches_jax."""
    if table_name == "kind_zero":
        jt, tt = _kind_zero_table(JT), _kind_zero_table(TT, device="cpu")
    else:
        _, jt, tt = next(t for t in _tables() if t[0] == table_name)
    S = tt.n_species
    kp = TT.kinds_present(tt) if pruned else None
    r2 = _r2_grid(np.unique(tt.rcut2.numpy()))
    si, sj = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    si, sj = si.reshape(-1, 1), sj.reshape(-1, 1)
    wj = np.asarray(JP.pair_virial(jnp.asarray(r2)[None, :], JT.gather_pair(jt, jnp.asarray(si), jnp.asarray(sj)), kp))
    wt = TP.pair_virial(torch.tensor(r2)[None, :], TT.gather_pair(tt, torch.tensor(si), torch.tensor(sj)), kp).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-13, atol=0.0)
    assert (wt[:, r2 > tt.rcut2.numpy().max()] == 0.0).all()


@pytest.mark.parametrize("table_name", ["Trimer", "kg_dict"])
def test_bond_potential_matches_jax(table_name):
    """FENE + LJ bond energy and virial on an r^2 grid that crosses rcutbond^2
    and r0^2: +inf beyond r0 (FENE), 0 for pairs without a bond."""
    _, jt, tt = next(t for t in _tables() if t[0] == table_name)
    S = tt.n_species
    r2 = np.concatenate([np.linspace(0.5, 1.8, 131) ** 2, np.unique(tt.r02.numpy()), np.unique(tt.rcut2b.numpy())])
    si, sj = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    si, sj = si.reshape(-1, 1), sj.reshape(-1, 1)
    pj = JT.gather_pair(jt, jnp.asarray(si), jnp.asarray(sj))
    pt = TT.gather_pair(tt, torch.tensor(si), torch.tensor(sj))
    r2j, r2t = jnp.asarray(r2)[None, :], torch.tensor(r2)[None, :]
    uj = np.asarray(JP.bond_potential(r2j, pj))
    ut = TP.bond_potential(r2t, pt).numpy()
    np.testing.assert_allclose(ut, uj, rtol=1e-13, atol=0.0)
    np.testing.assert_allclose(TP.bond_virial(r2t, pt).numpy(), np.asarray(JP.bond_virial(r2j, pj)), rtol=1e-13, atol=0.0)
    bonded = tt.has_bond.numpy().reshape(-1) > 0
    beyond = r2[None, :] > tt.r02.numpy().reshape(-1, 1)
    assert np.isposinf(ut[bonded[:, None] & beyond]).all()
    assert (ut[~bonded] == 0.0).all()
    assert np.isfinite(ut[bonded[:, None] & ~beyond]).all()
    # the FENE term alone, inside r0
    r2in = torch.tensor([0.5, 1.0, 2.0])
    np.testing.assert_allclose(
        TP.fene(r2in, -15.0, 2.25).numpy(), np.asarray(JP.fene(jnp.asarray(r2in.numpy()), -15.0, 2.25)), rtol=1e-14
    )


def test_interaction_range_includes_bonds():
    tt = TT.Trimer(device="cpu")
    assert TT.interaction_range(tt) == pytest.approx(1.575)
    assert TT.interaction_range(tt) == JT.interaction_range(JT.Trimer()) > tt.max_cutoff

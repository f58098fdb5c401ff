"""Parity of the port's state and energy with the JAX package, and the
reference's golden energy gate on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core import geometry as TG
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.models import tables as TT

from .helpers import load_fixture

torch.set_num_threads(1)


def _port_fixture_system(dtype=torch.float64):
    fx = load_fixture("config_0.npz")
    st = make_system(
        fx["position"], fx["species"], float(fx["density"]), float(fx["temperature"]),
        box=fx["box"], dtype=dtype, device="cpu",
    )
    table = TT.resolve_model(str(fx["model"]), len(np.unique(fx["species"])), dtype, "cpu")
    return st, table, fx


def test_atomic_golden_energy():
    """The reference's gate: -2.676832 per particle for config_0 (2D JBB)."""
    st, table, fx = _port_fixture_system()
    st = TE.initialize_energy(st, table)
    e = float(st.energy[0]) / st.n_particles
    assert e == pytest.approx(float(fx["golden_energy_per_particle"]), abs=1e-6)


def _random_ka(n, d, density, seed, chains):
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per = int(np.ceil(n ** (1 / d)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1)
    grid = grid.reshape(-1, d)[:n]
    pos = grid[None] + rng.uniform(-0.2 * a, 0.2 * a, (chains, n, d))
    species = (rng.random((chains, n)) < 0.2).astype(np.int64) + 1
    return pos, species, L


@pytest.mark.parametrize("d", [2, 3])
def test_total_energy_dense_matches_jax(d):
    pos, species, L = _random_ka(400, d, 1.2, seed=d, chains=2)
    jt = JT.KobAndersen()
    st = make_system(pos, species, 1.2, 1.0, device="cpu")
    e_port = TE.total_energy_dense(st.position, st.species, st.box, TT.KobAndersen(device="cpu")).numpy()
    for k in range(2):
        js = j_make_system(pos[k], species[k], 1.2, 1.0)
        e_jax = float(JE.total_energy_dense(js.position, js.species, js.box, jt))
        assert e_port[k] == pytest.approx(e_jax, rel=1e-12)


def test_initialize_energy_batched_and_mixed():
    pos, species, _ = _random_ka(300, 2, 1.2, seed=5, chains=3)
    t64 = TT.KobAndersen(device="cpu")
    st = TE.initialize_energy(make_system(pos, species, 1.2, 1.0, device="cpu"), t64)
    assert st.energy.shape == (3,) and st.energy.dtype == torch.float64
    # mixed precision: float32 state, float64 ledger started at float64
    st32 = make_system(pos, species, 1.2, 1.0, dtype=torch.float32, device="cpu")
    st32 = TE.initialize_energy(st32, TT.KobAndersen(torch.float32, "cpu"), energy_dtype=torch.float64)
    assert st32.position.dtype == torch.float32 and st32.energy.dtype == torch.float64
    np.testing.assert_allclose(st32.energy.numpy(), st.energy.numpy(), rtol=1e-5)


def test_initialize_energy_rejects_overlap():
    """An exactly overlapping pair overflows the float32 LJ core to +inf: the
    start energy is rejected, as in the reference package."""
    pos, species, _ = _random_ka(200, 2, 1.0, seed=1, chains=1)
    pos[0, 1] = pos[0, 0]
    st = make_system(pos, species, 1.0, 1.0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="infinite or NaN"):
        TE.initialize_energy(st, TT.KobAndersen(torch.float32, "cpu"))
    js = j_make_system(pos[0], species[0], 1.0, 1.0, dtype=jnp.float32)
    with pytest.raises(ValueError, match="infinite or NaN"):
        JE.initialize_energy(js, JT.KobAndersen(jnp.float32))


def test_geometry_matches_jax():
    from particlesmc_tpu.core import geometry as JG

    rng = np.random.default_rng(0)
    x = rng.uniform(-30.0, 30.0, (64, 3))
    y = rng.uniform(-30.0, 30.0, (64, 3))
    box = np.array([10.0, 11.5, 9.25])
    # exact half-box separations exercise round-half-to-even
    x[0], y[0] = [5.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(
        TG.fold_back(torch.tensor(x), torch.tensor(box)).numpy(),
        np.asarray(JG.fold_back(jnp.asarray(x), jnp.asarray(box))),
    )
    np.testing.assert_array_equal(
        TG.dist2(torch.tensor(x), torch.tensor(y), torch.tensor(box)).numpy(),
        np.asarray(JG.dist2(jnp.asarray(x), jnp.asarray(y), jnp.asarray(box))),
    )
    for d in range(5):
        assert TG.volume_sphere(1.3, d) == JG.volume_sphere(1.3, d)
    assert jax.config.jax_enable_x64

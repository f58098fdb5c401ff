"""The port's spatial slab decomposition (parallel/spatial.py) against its
own unsharded hyper-sweep and against the JAX package's
build_spatial_hyper_sweep_fn (tests/test_spatial.py's checks). On the same
generator the slab run makes the unsharded run's moves exactly: any halo,
image or parity error shows as a different trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu.parallel import spatial as JSP
from particlesmc_tpu_torch.core import energy as TE
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB
from particlesmc_tpu_torch.parallel import mesh as PM
from particlesmc_tpu_torch.parallel import spatial as TSP

from .test_torch_cb_moves import reference_draws
from .test_torch_checkerboard import port_cb_state
from .test_torch_inputs import wide_config

torch.set_num_threads(1)


def wide_system(seed=0, temperature=1.0, chains=1):
    pos, sp, box, rho = wide_config(seed=seed)
    table = TT.KobAndersen(device="cpu")
    st = make_system(pos, sp, rho, temperature, box=box, device="cpu")
    return TE.initialize_energy(st, table).repeat(chains), table


DISP_SWAP = (TMB.displacement(0.1, 0.8), TMB.discrete_swap(0, 1, 0.2))


def _sharded_vs_unsharded(P, pool, temperature=1.0, seed=0, calls=1, inner=3, chains=1):
    st, table = wide_system(seed, temperature, chains)
    n = st.n_particles
    spec = TCB.make_cb_spec(st.box[0].numpy(), table.max_cutoff, n)
    assert spec.ncells == (16, 4)
    params = TMB.init_pool_params(pool, device="cpu")
    ref = TCB.build_hyper_sweep_fn(spec, table, n, inner=inner, pool=pool)
    sp = TSP.build_spatial_hyper_sweep_fn(spec, table, n, PM.make_mesh(P, "cpu"), inner=inner, pool=pool)
    a = TCB.init_cb_state(st, spec, seed=4, n_moves=len(pool))
    b = TCB.init_cb_state(st, spec, seed=4, n_moves=len(pool))
    for _ in range(calls):
        a, b = ref(a, params), sp(b, params)
    return a, b, table


def _assert_exact(a, b, table):
    """Same counters, species and positions bitwise; the energies (summed in
    another order) within 1e-12; the ledger equals a dense recompute."""
    assert not bool(b.overflow.any())
    assert torch.equal(a.attempted, b.attempted) and torch.equal(a.accepted, b.accepted)
    assert torch.equal(a.system.species, b.system.species)
    assert torch.equal(a.system.position, b.system.position)
    assert torch.equal(a.planes, b.planes) and torch.equal(a.generator.get_state(), b.generator.get_state())
    np.testing.assert_allclose(b.system.energy.numpy(), a.system.energy.numpy(), rtol=1e-12)
    s = b.system
    np.testing.assert_allclose(
        s.energy.numpy(), TE.total_energy_dense(s.position, s.species, s.box, table).numpy(), rtol=1e-9, atol=1e-7
    )
    assert int(b.accepted.sum()) > 50


@pytest.mark.parametrize("pool", [(TMB.displacement(0.1),), DISP_SWAP], ids=["disp", "disp+swap"])
def test_spatial_p2_matches_unsharded_exactly(pool):
    """P = 2 slabs in one process (a device list of CPU slabs) against the
    unsharded sweep on the same generator: exact."""
    a, b, table = _sharded_vs_unsharded(2, pool, temperature=5.0 if len(pool) > 1 else 1.0)
    _assert_exact(a, b, table)


@pytest.mark.slow
@pytest.mark.parametrize("P", [1, 4, 8])
def test_spatial_matches_unsharded_exactly(P):
    """P = 1, 4 and 8 slabs, two chains, three calls of the
    Displacement + DoubleUniform pool at T = 5 (swaps accepted)."""
    a, b, table = _sharded_vs_unsharded(P, DISP_SWAP, temperature=5.0, calls=3, chains=2)
    _assert_exact(a, b, table)
    assert (b.accepted[:, 1] > 0).all()


@pytest.mark.parametrize("pool_kind", ["disp", "disp+swap"])
def test_spatial_p2_matches_jax(pool_kind):
    """P = 2 against the JAX package's spatial hyper-sweep on a 2-device
    mesh with its draws injected: same counters and species, positions
    within 1e-9, energy within rtol 1e-9."""
    pos, sp, box, rho = wide_config(seed=3)
    temperature = 5.0 if pool_kind != "disp" else 1.0
    jt = JT.KobAndersen()
    js = JE.initialize_energy(j_make_system(pos, sp, rho, temperature, box=box), jt)
    n = js.n_particles
    spec = JCB.make_cb_spec(np.asarray(js.box), jt.max_cutoff, n)
    if pool_kind == "disp":
        pool_j, pool_t = (JMB.displacement(0.1),), (TMB.displacement(0.1),)
    else:
        pool_j = (JMB.displacement(0.1, 0.8), JMB.discrete_swap(0, 1, 0.2))
        pool_t = DISP_SWAP
    mesh = JMesh(np.array(jax.devices()[:2]), ("space",))
    fn = jax.jit(JSP.build_spatial_hyper_sweep_fn(spec, jt, n, mesh, axis="space", inner=3, pool=pool_j))
    cb_j = JCB.init_cb_state(js, spec, seed=11, n_moves=len(pool_j))
    out_j = fn(cb_j, JMB.init_pool_params(pool_j))
    C, A = 4, spec.n_active
    R = max(1, -(-n // (A * 3 * C)))
    draws = reference_draws(cb_j.key, 2, R, C, 3, A, pool_kind != "disp")
    draws = {k: torch.tensor(v)[None] for k, v in draws.items()}
    st, table = wide_system(seed=3, temperature=temperature)
    cb_t = port_cb_state(st, [cb_j])
    tspec = TCB.CBSpec(spec.ncells, spec.cap)
    hs = TSP.build_spatial_hyper_sweep_fn(tspec, table, n, PM.make_mesh(2, "cpu"), inner=3, pool=pool_t)
    out_t = hs(cb_t, TMB.init_pool_params(pool_t, device="cpu"), **draws)
    np.testing.assert_array_equal(out_t.attempted[0].numpy(), np.asarray(out_j.attempted))
    np.testing.assert_array_equal(out_t.accepted[0].numpy(), np.asarray(out_j.accepted))
    np.testing.assert_array_equal(out_t.system.species[0].numpy(), np.asarray(out_j.system.species))
    np.testing.assert_allclose(out_t.system.position[0].numpy(), np.asarray(out_j.system.position), atol=1e-9)
    np.testing.assert_allclose(float(out_t.system.energy[0]), float(out_j.system.energy), rtol=1e-9)
    assert int(out_t.accepted.sum()) > 50


def test_slab_width_matches_jax():
    for ncells, P in [((16, 4), 8), ((16, 4), 4), ((16, 4), 3), ((12, 4), 2), ((12, 4), 4), ((8, 8, 8), 2),
                      ((6, 4), 2), ((4, 4), 1)]:
        want = JSP.spatial_slab_width(JCB.CBSpec(ncells=ncells, cap=8), P)
        assert TSP.spatial_slab_width(TCB.CBSpec(ncells=ncells, cap=8), P) == want
    assert TSP.spatial_slab_width(TCB.CBSpec((16, 4), 8), 8) == 2
    assert TSP.spatial_slab_width(TCB.CBSpec((12, 4), 8), 4) is None


def test_spatial_refuses_what_jax_refuses():
    """Slabs that cannot be even, and pools other than Displacement and
    DoubleUniform swaps, raise the JAX package's ValueError."""
    table = TT.KobAndersen(device="cpu")
    spec = TCB.CBSpec((12, 4), 8)
    with pytest.raises(ValueError, match="cannot shard into even slabs"):
        TSP.build_spatial_hyper_sweep_fn(spec, table, 100, PM.make_mesh(4, "cpu"))
    bias = TMB.discrete_swap(0, 1, 0.5, policy="energy_bias")
    with pytest.raises(ValueError, match="spatial backend supports"):
        TSP.build_spatial_hyper_sweep_fn(spec, table, 100, PM.make_mesh(2, "cpu"), pool=(bias,))
    with pytest.raises(ValueError, match="spatial backend supports"):
        TSP.build_spatial_hyper_sweep_fn(spec, table, 100, PM.make_mesh(2, "cpu"), pool=(TMB.molecule_flip(1.0),))


def test_make_mesh():
    """CPU slabs, a device list that repeats one device, and the refusal of
    more cards than are visible."""
    assert PM.make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    m = PM.make_mesh(device=["cpu", "cpu"])
    assert m.size == 2 and m.first == 0 and m.group is None
    with pytest.raises(ValueError, match="visible"):
        PM.make_mesh(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="backend"):
        PM.init_distributed("meta")
    blocks = PM.shard_chains({"x": torch.arange(8.0)}, PM.make_mesh(4, "cpu"))
    assert [b["x"].tolist() for b in blocks] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    copies = PM.replicate({"y": torch.ones(2)}, PM.make_mesh(device=["cpu", "cpu"]))
    assert len(copies) == 2 and all(torch.equal(c["y"], torch.ones(2)) for c in copies)


def _sim(tmp_path, spatial, nsim=1, steps=2, molecular=False):
    pos, sp, box, rho = wide_config(seed=5)
    table = TT.KobAndersen(device="cpu")
    st = TE.initialize_energy(make_system(pos, sp, rho, 1.0, box=box, device="cpu"), table).repeat(nsim)
    if molecular:
        st = st.replace(molecule=torch.arange(st.n_particles).expand(nsim, -1).clone(),
                        bonds=torch.full((nsim, st.n_particles, 1), -1))
    chains = Chains(states=st, table=table, list_type="cell", list_parameters={"inner": 3, "rebin_every": 2},
                    n_chains=nsim)
    algos = [dict(algorithm="Metropolis", pool=DISP_SWAP, seed=9, parallel_moves=True, spatial_devices=spatial)]
    return Simulation(chains, algos, steps, path=str(tmp_path))


def test_simulation_spatial_devices(tmp_path):
    """spatial_devices = 2 through Simulation on CPU slabs ends where the
    unsharded run ends; nsim > 1, a molecular system and a grid that cannot
    be cut raise the JAX engine's ValueErrors."""
    a = _sim(tmp_path / "a", 0).run()
    b = _sim(tmp_path / "b", 2).run()
    assert b.spatial_mesh is not None and b.spatial_mesh.size == 2 and a.spatial_mesh is None
    assert torch.equal(a.mc.system.position, b.mc.system.position)
    assert torch.equal(a.mc.accepted, b.mc.accepted) and int(b.mc.accepted.sum()) > 0
    with pytest.raises(ValueError, match="nsim = 1"):
        _sim(tmp_path / "c", 2, nsim=2)
    with pytest.raises(ValueError, match="atomic systems only"):
        _sim(tmp_path / "d", 2, molecular=True)
    with pytest.raises(ValueError, match="cannot shard into even"):
        _sim(tmp_path / "e", 3)

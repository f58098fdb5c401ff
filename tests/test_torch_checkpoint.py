"""The port's checkpoints (particlesmc_tpu_torch/io/checkpoint.py) and exact
resume through the engine and the CLI: the patterns of
tests/test_checkpoint.py and tests/test_simulation.py's lastframe restart,
each bitwise within the port, and the file layout against the JAX
package's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesmc_tpu.core import energy as JE
from particlesmc_tpu.core.state import make_system as j_make_system
from particlesmc_tpu.io import checkpoint as JC
from particlesmc_tpu.models import tables as JT
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu.moves import checkerboard as JCB
from particlesmc_tpu.moves import kernel as JK
from particlesmc_tpu_torch import cli
from particlesmc_tpu_torch.core import neighbours as TNB
from particlesmc_tpu_torch.core.energy import initialize_energy
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine.pgmc import BLANPG, VPG
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io import checkpoint as TC
from particlesmc_tpu_torch.io import formats as TF
from particlesmc_tpu_torch.io.loader import Chains, load_chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as TCB
from particlesmc_tpu_torch.moves import kernel as TK

torch.set_num_threads(1)


def _arrays(m=2, n=32, seed=0, density=0.5):
    """tests/test_checkpoint.py's start: 2D KA jittered lattices, species 1
    and 2 at random."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** 0.5
    per = int(np.ceil(n ** 0.5))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * 2, indexing="ij"), -1).reshape(-1, 2)[:n]
    pos = np.stack([grid + rng.uniform(-0.05 * a, 0.05 * a, (n, 2)) for _ in range(m)])
    sp = rng.integers(1, 3, (m, n))
    return pos, sp, density


def _batch(m=2, n=32, seed=0):
    pos, sp, rho = _arrays(m, n, seed)
    table = TT.KobAndersen(device="cpu")
    return initialize_energy(make_system(pos, sp, rho, 1.2, device="cpu"), table), table


def _chains(m=2, n=48, seed=0):
    st, table = _batch(m, n, seed)
    return Chains(states=st, table=table, list_type="dense", n_chains=m)


def _same_state(a, b):
    for f in ("position", "species", "energy"):
        assert torch.equal(getattr(a.system, f), getattr(b.system, f)), f
    assert torch.equal(a.attempted, b.attempted) and torch.equal(a.accepted, b.accepted)


@pytest.mark.parametrize("cells", [False, True], ids=["dense", "cells"])
def test_checkpoint_exact_resume(tmp_path, cells):
    """Four sweeps straight through equal two sweeps, a checkpoint, a load
    and two sweeps: bitwise with the dense ΔE. With a cell list the load
    rebuilds the buckets in particle order, so the candidates' sum order
    (not the moves) changes: positions, species and counters bitwise, the
    ledger within rtol 1e-12."""
    system, table = _batch()
    pool = (TMB.displacement(0.1),)
    spec = TNB.make_spec(system.box[0].numpy(), table.max_cutoff, 32) if cells else None
    assert (spec is not None) == cells
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=spec)
    params = TMB.init_pool_params(pool, device="cpu")
    sweep = TK.build_sweep_fn(config, 32)
    mc = TK.init_mc_state(system, config, 7)
    for _ in range(4):
        mc = sweep(mc, params)
    ref = mc

    mc = TK.init_mc_state(system, config, 7)
    for _ in range(2):
        mc = sweep(mc, params)
    path = tmp_path / "state.npz"
    TC.save_checkpoint(str(path), mc, params, step=2, extra={"note": "test"})
    mc2, params2, t = TC.load_checkpoint(str(path), config, device="cpu")
    assert t == 2 and torch.equal(mc2.attempted, mc.attempted) and not mc2.flip_failed.any()
    assert torch.equal(mc2.generator.get_state(), mc.generator.get_state())
    for _ in range(2):
        mc2 = sweep(mc2, params2)
    if cells:
        for f in ("position", "species"):
            assert torch.equal(getattr(ref.system, f), getattr(mc2.system, f)), f
        assert torch.equal(ref.attempted, mc2.attempted) and torch.equal(ref.accepted, mc2.accepted)
        np.testing.assert_allclose(mc2.system.energy.numpy(), ref.system.energy.numpy(), rtol=1e-12)
        fresh = TNB.build_cell_list(mc2.system.position, mc2.system.box, spec)
        assert torch.equal(fresh.count, mc2.cell.count)
    else:
        _same_state(ref, mc2)
    assert int(ref.accepted.sum()) > 0


def test_checkpoint_checkerboard_exact_resume(tmp_path):
    """The checkerboard backend: four hyper-sweeps straight through equal two,
    a checkpoint, a load (planes rebuilt) and two, bitwise."""
    system, table = _batch(m=2, n=140)
    spec = TCB.make_cb_spec(system.box[0].numpy(), table.max_cutoff, 140)
    assert spec is not None
    pool = (TMB.displacement(0.1),)
    params = TMB.init_pool_params(pool, device="cpu")
    hs = TCB.build_hyper_sweep_fn(spec, table, 140, inner=2, pool=pool)
    cb = TCB.init_cb_state(system, spec, 3)
    for _ in range(4):
        cb = hs(cb, params)
    ref = cb
    cb = TCB.init_cb_state(system, spec, 3)
    for _ in range(2):
        cb = hs(cb, params)
    path = tmp_path / "cb.npz"
    TC.save_checkpoint(str(path), cb, params, step=2)
    cb2, params2, t = TC.load_checkpoint_checkerboard(str(path), spec, device="cpu")
    assert t == 2 and float(params2[0]["sigma"]) == 0.1 and torch.equal(cb2.skipped, cb.skipped)
    for _ in range(2):
        cb2 = hs(cb2, params2)
    _same_state(ref, cb2)
    assert int(ref.accepted.sum()) > 0


def test_checkpoint_roundtrips_params(tmp_path):
    """A checkpoint written by StoreCheckpoints after PGMC updates holds the
    learned θ bitwise, under each move's names."""
    st, table = _batch(m=2, n=48)
    chains = Chains(states=st.replace(temperature=torch.full_like(st.temperature, 1.0)), table=table,
                    list_type="dense", n_chains=2)
    pool = (TMB.displacement(0.1, 0.7), TMB.discrete_swap(0, 1, 0.3, policy="energy_bias", theta1=0.2))
    algos = [
        dict(algorithm="Metropolis", pool=pool, seed=1),
        dict(algorithm="PolicyGradientEstimator", optimisers=(VPG(1e-3), BLANPG(1e-4, 1e-6)), q_batch_size=3),
        dict(algorithm="PolicyGradientUpdate", scheduler=[1, 2]),
        dict(algorithm="StoreCheckpoints", scheduler=[2]),
    ]
    sim = Simulation(chains, algos, 2, path=str(tmp_path)).run()
    config = TK.KernelConfig(pool=pool, table=table, cell_spec=None)
    mc, params, t = TC.load_checkpoint(str(tmp_path / "checkpoint.npz"), config, device="cpu")
    assert t == 2 and set(params[0]) == {"sigma"} and list(params[1]) == ["theta1", "theta2"]
    for p, q in zip(params, sim.pool_params):
        for k in q:
            assert torch.equal(p[k], q[k]), k
    assert float(params[1]["theta1"]) != 0.2 and float(params[0]["sigma"]) != 0.1  # learned
    _same_state(sim.mc, mc)


@pytest.mark.parametrize("backend", ["dense", "checkerboard"])
def test_engine_resume_bitwise(tmp_path, backend):
    """A Simulation resumed mid-schedule from a StoreCheckpoints file equals
    the straight-through run bitwise (positions, species, energies,
    counters), and refuses a checkpoint past its steps."""
    cb = backend == "checkerboard"
    pool = (TMB.displacement(0.1, probability=0.7), TMB.discrete_swap(0, 1, 0.3))
    steps, n = 8, (140 if cb else 48)
    metro = dict(algorithm="Metropolis", pool=pool, seed=3)
    if cb:
        metro["parallel_moves"] = True

    def sim(path, resume=None, steps=steps):
        chains = _chains(n=n)
        if cb:
            chains.list_parameters = {"inner": 2, "rebin_every": 2}
        return Simulation(chains, [metro, dict(algorithm="StoreCheckpoints", scheduler=[4])], steps,
                          path=str(path), resume=resume)

    a = sim(tmp_path / "a").run()
    b = sim(tmp_path / "a", resume=str(tmp_path / "a" / "checkpoint.npz"))
    assert b._start_step == 4
    b.run()
    _same_state(a.mc, b.mc)
    assert a.parallel_moves == cb and int(a.mc.accepted[:, 1].sum()) > 0
    with pytest.raises(ValueError, match="past the requested"):
        sim(tmp_path / "c", resume=str(tmp_path / "a" / "checkpoint.npz"), steps=4)


CLI_PARAMS = """
[system]
config = "{cfg}"
temperature = 1.5
model = "KobAndersen"
list_type = "EmptyList"

[simulation]
type = "Metropolis"
steps = 10
seed = 10
verbose = false
output_path = "{out}"

[[simulation.move]]
action = "Displacement"
probability = 1.0
policy = "SimpleGaussian"
parameters = {{sigma = 0.05}}

[[simulation.output]]
algorithm = "StoreCallbacks"
callbacks = ["energy"]
scheduler_params = {{linear_interval = 5}}

[[simulation.output]]
algorithm = "StoreCheckpoints"
scheduler_params = {{linear_interval = 5}}
{history}
"""


def test_cli_resume(tmp_path):
    """tests/test_checkpoint.py::test_cli_resume on the port's CLI: --resume
    continues mid-schedule and appends to the outputs; the final energy row
    equals the straight-through run's exactly. A missing checkpoint file
    prints and returns 1."""
    pos, sp, rho = _arrays(m=1, n=48)
    cfg = tmp_path / "config.xyz"
    L = (48 / rho) ** 0.5
    cfg.write_text(TF.write_xyz_frame(sp[0], pos[0], np.full(2, L), 0, rho, 1.5))
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(CLI_PARAMS.format(cfg=cfg, out=tmp_path / "data", history=""))
    run = lambda *a: cli.main([str(ptoml), "--device", "cpu", *a])  # noqa: E731
    assert run() == 0
    energy = tmp_path / "data" / "chains" / "1" / "energy.dat"
    e_full = np.loadtxt(energy)
    assert e_full.shape == (3, 2) and (tmp_path / "data" / "checkpoint.npz").exists()
    ptoml.write_text(CLI_PARAMS.format(cfg=cfg, out=tmp_path / "data", history="history = true"))
    assert run() == 0
    mid = tmp_path / "data" / "checkpoint_5.npz"
    assert mid.exists() and (tmp_path / "data" / "checkpoint_10.npz").exists()
    with open(energy, "w") as f:
        for r in e_full[e_full[:, 0] <= 5]:
            f.write(f"{int(r[0])} {r[1]:.12g}\n")
    assert run("--resume", str(mid)) == 0
    e_res = np.loadtxt(energy)
    assert e_res.shape == (3, 2)
    np.testing.assert_array_equal(e_res, e_full)
    assert run("--resume", str(tmp_path / "missing.npz")) == 1


def test_lastframe_restart_roundtrip(tmp_path):
    """tests/test_simulation.py::test_lastframe_restart_roundtrip on the port:
    a last frame is a valid restart input whose energy is the final ledger's
    up to the writer's precision."""
    pos, sp, rho = _arrays(m=1, n=32)
    cfg = tmp_path / "config.xyz"
    cfg.write_text(TF.write_xyz_frame(sp[0], pos[0], np.full(2, (32 / rho) ** 0.5), 0, rho, 1.2))
    args = {"temperature": 1.2, "model": "KobAndersen", "list_type": "EmptyList"}
    chains = load_chains(str(cfg), args=args, device="cpu")
    algos = [dict(algorithm="Metropolis", pool=(TMB.displacement(0.1),), seed=1),
             dict(algorithm="StoreLastFrames", scheduler=[5], fmt="XYZ")]
    sim = Simulation(chains, algos, 5, path=str(tmp_path / "run1")).run()
    chains2 = load_chains(str(tmp_path / "run1" / "chains" / "1" / "lastframe.xyz"), args=args, device="cpu")
    assert float(chains2.states.energy[0]) == pytest.approx(float(sim.mc.system.energy[0]), abs=1e-2)
    assert float(chains2.states.energy[0]) != float(chains.states.energy[0])


def _jax_batch(m=2, n=32):
    pos, sp, rho = _arrays(m, n)
    table = JT.KobAndersen()
    sts = [JE.initialize_energy(j_make_system(pos[b], sp[b], rho, 1.2, dtype=jnp.float64), table, check=False)
           for b in range(m)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sts), table


@pytest.mark.parametrize("backend", ["sequential", "checkerboard"])
def test_checkpoint_layout_matches_jax(tmp_path, backend):
    """For the same state both packages write the same arrays under the same
    names, but for the random state (JAX's `key`; the port's
    `generator_state`) and the sequential sampler's `flip_failed`, which the
    port adds; meta_json names the same parameters. The port refuses to
    load the JAX package's checkpoint."""
    cb = backend == "checkerboard"
    n = 140 if cb else 32
    batch, jt = _jax_batch(n=n)
    pool_j = (JMB.displacement(0.1), JMB.discrete_swap(0, 1, 0.3, policy="energy_bias", theta1=0.2))
    pool_t = (TMB.displacement(0.1), TMB.discrete_swap(0, 1, 0.3, policy="energy_bias", theta1=0.2))
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    system, table = _batch(n=n)
    if cb:
        spec = JCB.make_cb_spec(np.asarray(batch.box[0]), jt.max_cutoff, n)
        mc_j = jax.vmap(lambda s, k: JCB.init_cb_state(s, spec, k, n_moves=2))(batch, keys)
        mc_t = TCB.init_cb_state(system, TCB.CBSpec(spec.ncells, spec.cap), 0, 2)
    else:
        config = JK.KernelConfig(pool=pool_j, table=jt, cell_spec=None)
        mc_j = jax.vmap(lambda s, k: JK.init_mc_state(s, config, k))(batch, keys)
        mc_t = TK.init_mc_state(system, TK.KernelConfig(pool=pool_t, table=table, cell_spec=None), 0)
    JC.save_checkpoint(str(tmp_path / "jax.npz"), mc_j, JMB.init_pool_params(pool_j), step=3)
    TC.save_checkpoint(str(tmp_path / "port.npz"), mc_t, TMB.init_pool_params(pool_t, device="cpu"), step=3)
    zj, zt = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    added = {"generator_state"} | (set() if cb else {"flip_failed"})
    assert set(zt.files) == (set(zj.files) - {"key"}) | added
    for k in set(zj.files) - {"key", "meta_json"}:
        assert zt[k].shape == zj[k].shape, k
    mj, mt = (json.loads(bytes(z["meta_json"]).decode()) for z in (zj, zt))
    assert mt["param_names"] == mj["param_names"] and mt["generator_device"] == "cpu"
    with pytest.raises(ValueError, match="JAX package"):
        TC.load_checkpoint(str(tmp_path / "jax.npz"), None, device="cpu")


def test_checkpoint_bound_to_device_type(tmp_path):
    """A checkpoint whose generator state belongs to another device type
    does not load, and the error names both types."""
    system, table = _batch()
    config = TK.KernelConfig(pool=(TMB.displacement(0.1),), table=table, cell_spec=None)
    mc = TK.init_mc_state(system, config, 0)
    path = tmp_path / "c.npz"
    TC.save_checkpoint(str(path), mc, TMB.init_pool_params(config.pool, device="cpu"), step=0)
    z = dict(np.load(path))
    meta = json.loads(bytes(z["meta_json"]).decode())
    meta["generator_device"] = "cuda"
    z["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **z)
    with pytest.raises(ValueError, match="cuda generator state .* cpu device"):
        TC.load_checkpoint(str(path), config, device="cpu")

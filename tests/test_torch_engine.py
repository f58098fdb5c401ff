"""The port's engine, I/O and CLI (particlesmc_tpu_torch/engine, io, cli)
against the JAX package's, run on the CPU (`--device cpu`)."""

import os

import numpy as np
import pytest
import torch

from particlesmc_tpu.cli import main as j_main
from particlesmc_tpu.engine.schedule import build_schedule as j_build_schedule
from particlesmc_tpu.engine.simulation import Simulation as JSimulation
from particlesmc_tpu.io import formats as JF
from particlesmc_tpu.io import loader as JL
from particlesmc_tpu.moves import base as JMB
from particlesmc_tpu_torch import cli
from particlesmc_tpu_torch.core.energy import total_energy_dense
from particlesmc_tpu_torch.engine.schedule import build_schedule
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io import formats as TF
from particlesmc_tpu_torch.io import loader as TL
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import checkerboard as CBK

from .helpers import FIXTURES, load_fixture

torch.set_num_threads(1)

SCHEDULES = [
    (100, 0, 10), (100, 7, 10), (100, 0, [0, 1, 2, 4, 8]), (50, 3, [0, 5, 10]),
    (1000, 0, 2.0), (1000, 10, 1.5), (64, 0, 2.0),
]


@pytest.mark.parametrize("steps,burn,spec", SCHEDULES)
def test_build_schedule_matches_jax(steps, burn, spec):
    np.testing.assert_array_equal(build_schedule(steps, burn, spec), j_build_schedule(steps, burn, spec))


def test_formats_match_jax_on_fixture():
    fx = load_fixture("config_0.npz")
    sp, pos, box = fx["species"], fx["position"], fx["box"]
    texts = {
        "xyz": (TF.write_xyz_frame(sp, pos, box, 3, fx["density"], fx["temperature"]),
                JF.write_xyz_frame(sp, pos, box, 3, fx["density"], fx["temperature"])),
        "exyz": (TF.write_exyz_frame(sp, pos, box, 3), JF.write_exyz_frame(sp, pos, box, 3)),
        "lammps": (TF.write_lammps_frame(sp, pos, box, 3), JF.write_lammps_frame(sp, pos, box, 3)),
    }
    parsed = {}
    for fmt, (t_text, j_text) in texts.items():
        assert t_text == j_text
        parsed[fmt] = TF._READERS[fmt](t_text)
        j_cfg = JF._READERS[fmt](j_text)
        np.testing.assert_array_equal(parsed[fmt]["position"], j_cfg["position"])
        np.testing.assert_array_equal(parsed[fmt]["species"], j_cfg["species"])
    for fmt in ("exyz", "lammps"):  # the three dialects agree
        np.testing.assert_allclose(parsed[fmt]["box"], parsed["xyz"]["box"], rtol=1e-12)
        np.testing.assert_allclose(parsed[fmt]["position"], parsed["xyz"]["position"], atol=1e-6)
    assert TF.FORMAT_EXTENSION == JF.FORMAT_EXTENSION
    assert TL.LIST_REGISTRY == JL.LIST_REGISTRY


def test_load_chains_matches_jax():
    """Density rescale, temperature ladder and nsim cloning on the movie frame."""
    path = os.path.join(os.path.dirname(FIXTURES), "..", "examples", "movie", "inputframe.exyz")
    args = {"temperature": [1.0, 1.5], "density": 1.1, "model": "JBB", "nsim": 2}
    tc = TL.load_chains(path, args=args, device="cpu")
    jc = JL.load_chains(path, args=args)
    assert tc.n_chains == jc.n_chains == 4 and tc.list_type == jc.list_type
    st, js = tc.states, jc.states
    np.testing.assert_allclose(st.position.numpy(), np.asarray(js.position), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(st.species.numpy(), np.asarray(js.species))
    np.testing.assert_allclose(st.box.numpy(), np.asarray(js.box), rtol=1e-15)
    np.testing.assert_array_equal(st.temperature.numpy(), np.asarray(js.temperature))
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(js.energy), rtol=1e-12)


def _write_config(path, n=150, d=2, density=1.19, seed=0):
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per = int(np.ceil(n ** (1 / d)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1)
    pos = grid.reshape(-1, d)[:n] + rng.uniform(-0.05 * a, 0.05 * a, (n, d))
    sp = rng.integers(1, 4, n)  # JBB species 1..3
    with open(path, "w") as f:
        f.write(TF.write_xyz_frame(sp, pos, np.full(d, L), 0, density, 1.0))


PARAMS = """
[system]
config = "config.xyz"
temperature = 1.0
density = 1.19
model = "JBB"
list_type = "LinkedList"
list_parameters = {{inner = 2, rebin_every = 4}}

[simulation]
type = "Metropolis"
steps = 10
seed = 10
parallel_moves = true
verbose = false
output_path = "{out}"

[[simulation.move]]
action = "Displacement"
probability = 1.0
policy = "SimpleGaussian"
parameters = {{sigma = 0.05}}

[[simulation.output]]
algorithm = "StoreCallbacks"
callbacks = ["energy", "acceptance"]
scheduler_params = {{linear_interval = 5}}

[[simulation.output]]
algorithm = "StoreAcceptance"
dependencies = ["Metropolis"]
scheduler_params = {{linear_interval = 5}}

[[simulation.output]]
algorithm = "StoreTrajectories"
scheduler_params = {{linear_interval = 5}}
fmt = "EXYZ"

[[simulation.output]]
algorithm = "StoreLastFrames"
scheduler_params = {{linear_interval = 10}}
fmt = "XYZ"

[[simulation.output]]
algorithm = "PrintTimeSteps"
scheduler_params = {{linear_interval = 5}}
"""


def _layout(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def test_cli_end_to_end_matches_jax_layout(tmp_path):
    _write_config(tmp_path / "config.xyz")
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(PARAMS.format(out=tmp_path / "port"))
    assert cli.main([str(ptoml), "--device", "cpu"]) == 0
    out = tmp_path / "port"
    e = np.loadtxt(out / "chains" / "1" / "energy.dat")
    np.testing.assert_array_equal(e[:, 0], [0, 5, 10])
    acc = np.loadtxt(out / "moves" / "1" / "acceptance.dat")
    assert acc.shape == (3, 2) and 0.0 < acc[-1, 1] < 1.0
    assert len(TF.read_trajectory(str(out / "chains" / "1" / "trajectory.exyz"))) == 3

    ptoml_j = tmp_path / "params_jax.toml"
    ptoml_j.write_text(PARAMS.format(out=tmp_path / "jax"))
    assert j_main([str(ptoml_j)]) == 0
    assert _layout(out) == _layout(tmp_path / "jax")
    e_j = np.loadtxt(tmp_path / "jax" / "chains" / "1" / "energy.dat")
    np.testing.assert_array_equal(e[:, 0], e_j[:, 0])
    assert e[0, 1] == pytest.approx(e_j[0, 1], rel=1e-12)  # same start energy

    # the final ledger equals a dense recompute
    sim = cli.run_file(str(ptoml), device="cpu")
    st = sim.mc.system
    e_dense = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    assert sim.mc.attempted.sum() > 0


@pytest.mark.parametrize(
    "edit,item",
    [
        (("seed = 10", 'seed = 10\nprofile_dir = "TRACE_DIR"'), "item 12"),
        (("rebin_every = 4}", "rebin_every = 4, trim = \"auto\"}"), "item 14"),
        (('callbacks = ["energy", "acceptance"]', 'callbacks = ["pressure"]'), "item 12"),
        (("rebin_every = 4}", "rebin_every = 4, trim = 96}"), "item 14"),
        (('callbacks = ["energy", "acceptance"]', 'callbacks = ["chain_correlation"]'), "item 12"),
        (("seed = 10", "seed = 10\nspatial_devices = 2"), "item 13"),
    ],
)
def test_unported_inputs_raise(tmp_path, edit, item):
    """The inputs of ROADMAP items 12 to 14, which raised NotImplementedError
    until the port covered them, run through the CLI (the final ledger equal
    to a dense recompute), or raise the JAX package's own ValueError:
    chain_correlation on an atomic system."""
    _write_config(tmp_path / "config.xyz")
    text = PARAMS.format(out=tmp_path / "out")
    assert edit[0] in text
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(text.replace(edit[0], edit[1].replace("TRACE_DIR", str(tmp_path / "trace"))))
    if "chain_correlation" in edit[1]:
        with pytest.raises(ValueError, match="requires a molecular system"):
            cli.main([str(ptoml), "--device", "cpu"])
        return
    sim = cli.run_file(str(ptoml), device="cpu")
    st = sim.mc.system
    e_dense = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    if "profile_dir" in edit[1]:
        assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
    elif "pressure" in edit[1]:
        p = np.loadtxt(tmp_path / "out" / "chains" / "1" / "pressure.dat")
        assert p.shape == (3, 2) and np.isfinite(p).all()
    elif "trim = 96" in edit[1]:
        assert sim.trim_k == 96 and sim._block(sim.rebin_every).plan.trim_k == 96
    elif "trim" in edit[1]:
        n = st.n_particles
        assert sim.trim_k == CBK.auto_trim_k(sim.cb_spec, st.box[0].numpy(), sim.chains.table.max_cutoff, n) == 128
    else:
        assert sim.spatial_mesh.size == 2 and int(sim.mc.accepted.sum()) > 0


def test_cli_smart_gaussian_ledger(tmp_path):
    """A SmartGaussian pool runs through the CLI; its final ledger equals a
    dense recompute."""
    _write_config(tmp_path / "config.xyz")
    text = PARAMS.format(out=tmp_path / "out").replace('policy = "SimpleGaussian"', 'policy = "SmartGaussian"')
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(text)
    sim = cli.run_file(str(ptoml), device="cpu")
    assert sim.pool[0].policy == "smart"
    st = sim.mc.system
    e_dense = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    acc = np.loadtxt(tmp_path / "out" / "moves" / "1" / "acceptance.dat")
    assert 0.0 < acc[-1, 1] < 1.0


def test_simulation_outputs_sequential(tmp_path):
    """tests/test_simulation.py::test_simulation_outputs on the port's
    sequential kernel: the same output files as the JAX package, rows at
    the scheduled steps, diverging chains, and the ledger equal to a dense
    recompute and to the last energy row."""
    cfg = tmp_path / "config.xyz"
    _write_config(cfg, n=48, density=0.5)
    args = {"temperature": 1.5, "model": "JBB", "list_type": "EmptyList", "nsim": 2}
    steps = 20
    sched = build_schedule(steps, 0, [0, 1, 2, 4, 8])

    def algorithms(mb):
        return [
            dict(algorithm="Metropolis", pool=(mb.displacement(0.1, 0.6), mb.discrete_swap(0, 1, 0.4)), seed=7),
            dict(algorithm="StoreCallbacks", callbacks=("energy",), scheduler=sched),
            dict(algorithm="StoreAcceptance", dependencies=("Metropolis",), scheduler=sched),
            dict(algorithm="StoreTrajectories", scheduler=sched, fmt="EXYZ"),
            dict(algorithm="StoreLastFrames", scheduler=[steps], fmt="XYZ"),
        ]

    out = tmp_path / "port"
    chains = TL.load_chains(str(cfg), args=args, device="cpu")
    sim = Simulation(chains, algorithms(TMB), steps, path=str(out))
    assert sim.neighbour_mode == "dense"
    sim.run()
    JSimulation(JL.load_chains(str(cfg), args=args), algorithms(JMB), steps, path=str(tmp_path / "jax")).run()
    assert _layout(out) == _layout(tmp_path / "jax")
    for k in (1, 2):
        e = np.loadtxt(out / "chains" / str(k) / "energy.dat")
        np.testing.assert_array_equal(e[:, 0], sched[sched <= steps])
        assert (out / "chains" / str(k) / "trajectory.exyz").read_text().count("Lattice=") == len(e)
        assert TF.read_xyz((out / "chains" / str(k) / "lastframe.xyz").read_text())["N"] == 48
    acc = np.loadtxt(out / "moves" / "2" / "acceptance.dat")
    assert ((acc[:, 1] >= 0) & (acc[:, 1] <= 1)).all() and acc[-1, 1] > 0
    e1, e2 = (np.loadtxt(out / "chains" / str(k) / "energy.dat")[:, 1] for k in (1, 2))
    assert not np.allclose(e1[1:], e2[1:])
    st = sim.mc.system
    e_dense = total_energy_dense(st.position, st.species, st.box, chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    assert e1[-1] == pytest.approx(float(st.energy[0]) / 48, abs=1e-9)
    assert (sim.mc.attempted.sum(dim=1) == steps * 48).all()
    assert "Neighbour mode: dense" in (out / "simulation.log").read_text()


@pytest.mark.parametrize("cells", [False, True], ids=["dense", "force_cells"])
def test_cli_end_to_end_sequential(tmp_path, cells):
    """tests/test_simulation.py::test_cli_end_to_end through the port's CLI
    with parallel_moves = false: the JAX CLI's output layout, the energy
    rows and the ledger; list_parameters.force_cells turns on the cell list
    (with its warning) and the summary names the mode."""
    _write_config(tmp_path / "config.xyz", n=150, density=0.5)
    lp = "{force_cells = true, cap = 24}" if cells else "{inner = 2}"
    text = (PARAMS.format(out=tmp_path / "port")
            .replace("parallel_moves = true", "parallel_moves = false\nsweepstep = 50")
            .replace("list_parameters = {inner = 2, rebin_every = 4}", f"list_parameters = {lp}")
            .replace("density = 1.19", "density = 0.5"))
    text += """
[[simulation.move]]
action = "DiscreteSwap"
probability = 0.3
policy = "DoubleUniform"
parameters = {species = [1, 3]}
"""
    ptoml = tmp_path / "params.toml"
    ptoml.write_text(text)
    if cells:
        with pytest.warns(UserWarning, match="cell-list"):
            sim = cli.run_file(str(ptoml), device="cpu")
    else:
        sim = cli.run_file(str(ptoml), device="cpu")
    out = tmp_path / "port"
    assert sim.neighbour_mode == ("cell" if cells else "dense")
    assert (sim.mc.cell is not None) == cells
    if cells:
        assert sim.config.cell_spec.cap == 24
    e = np.loadtxt(out / "chains" / "1" / "energy.dat")
    np.testing.assert_array_equal(e[:, 0], [0, 5, 10])
    assert (out / "moves" / "2" / "acceptance.dat").exists()
    st = sim.mc.system
    e_dense = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
    np.testing.assert_allclose(st.energy.numpy(), e_dense.numpy(), rtol=1e-9, atol=1e-9)
    assert f"Neighbour mode: {sim.neighbour_mode}" in (out / "simulation.log").read_text()
    if not cells:
        ptoml_j = tmp_path / "params_jax.toml"
        ptoml_j.write_text(text.replace(str(tmp_path / "port"), str(tmp_path / "jax")))
        assert j_main([str(ptoml_j)]) == 0
        assert _layout(out) == _layout(tmp_path / "jax")


def test_sequential_per_chain_boxes(tmp_path):
    """Chains with their own boxes run on the dense path; the cell list
    refuses them."""
    _write_config(tmp_path / "config.xyz", n=48, density=0.5)
    args = {"temperature": 1.5, "model": "JBB", "nsim": 2, "list_type": "CellList",
            "list_parameters": {"force_cells": True}}
    chains = TL.load_chains(str(tmp_path / "config.xyz"), args=args, device="cpu")
    st = chains.states
    chains.states = st.replace(position=st.position * torch.tensor([1.0, 1.1])[:, None, None],
                               box=st.box * torch.tensor([1.0, 1.1])[:, None])
    algos = [dict(algorithm="Metropolis", pool=(TMB.displacement(0.1),), seed=1)]
    with pytest.raises(ValueError, match="share one box"):
        Simulation(chains, algos, 2, path=str(tmp_path / "a"))
    chains.list_type = "dense"
    chains.states = chains.states.replace(energy=total_energy_dense(
        chains.states.position, chains.states.species, chains.states.box, chains.table))
    sim = Simulation(chains, algos, 2, path=str(tmp_path / "b")).run()
    s = sim.mc.system
    np.testing.assert_allclose(s.energy.numpy(), total_energy_dense(s.position, s.species, s.box, chains.table).numpy(),
                               rtol=1e-9)
    assert not torch.equal(s.box[0], s.box[1])


def test_cli_missing_file():
    assert cli.main(["/nonexistent/params.toml", "--device", "cpu"]) == 1


@pytest.mark.slow
def test_movie_energy_agrees_with_jax(tmp_path):
    """A shortened examples/movie run with 8 independent chains through both
    CLIs: the mean energy per particle after burn-in agrees within 3
    standard errors of the chain means."""
    src = os.path.join(os.path.dirname(FIXTURES), "..", "examples", "movie")
    with open(os.path.join(src, "params.toml")) as f:
        text = f.read()
    runs = {"port": lambda p: cli.main([p, "--device", "cpu"]), "jax": lambda p: j_main([p])}
    stats = []
    for name, run in runs.items():
        t = text
        for old, new in (
            ('config = "inputframe.exyz"', f'config = "{os.path.join(src, "inputframe.exyz")}"'),
            ("steps = 50000", "steps = 400\nburn = 100\nnsim = 8"),
            ('output_path = "./"', f'output_path = "{tmp_path / name}"'),
            ("linear_interval = 500", "linear_interval = 10"),
            ("linear_interval = 1000", "linear_interval = 400"),
        ):
            assert old in t
            t = t.replace(old, new)
        p = tmp_path / f"{name}.toml"
        p.write_text(t)
        assert run(str(p)) == 0
        chain_means = [
            np.loadtxt(tmp_path / name / "chains" / str(k) / "energy.dat")[:, 1].mean()
            for k in range(1, 9)
        ]
        stats.append((np.mean(chain_means), np.std(chain_means, ddof=1) / np.sqrt(8)))
    (m1, s1), (m2, s2) = stats
    assert abs(m1 - m2) < 3 * np.hypot(s1, s2), stats

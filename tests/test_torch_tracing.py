"""The port's spans and counters (particlesmc_tpu_torch/tracing.py): the
calls themselves, where the layers put them (every span name in a profiled
CPU run of each backend, nested as documented), and that no other file of
the port opens a profiler range of its own."""

import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from particlesmc_tpu_torch import tracing
from particlesmc_tpu_torch.core.energy import initialize_energy
from particlesmc_tpu_torch.core.state import make_system
from particlesmc_tpu_torch.engine.simulation import Simulation
from particlesmc_tpu_torch.io.loader import Chains
from particlesmc_tpu_torch.models import tables as TT
from particlesmc_tpu_torch.moves import base as TMB
from particlesmc_tpu_torch.moves import cb_cuda

torch.set_num_threads(1)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "particlesmc_tpu_torch")
LAUNCHES = "cb_cuda.launches"


def _system(n, rho, n_chains=1, seed=0):
    """KA 2D chains of one jittered square lattice each, f64 on the CPU."""
    rng = np.random.default_rng(seed)
    L = (n / rho) ** 0.5
    per = int(np.ceil(n**0.5))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * 2, indexing="ij"), -1).reshape(-1, 2)[:n]
    pos = np.stack([grid + rng.uniform(-0.05 * a, 0.05 * a, (n, 2)) for _ in range(n_chains)])
    table = TT.KobAndersen(device="cpu")
    return make_system(pos, rng.integers(1, 3, (n_chains, n)), rho, 1.0, device="cpu"), table


def _sim(tmp_path, parallel, list_type, params, pool, n, rho, n_chains=1, steps=2, **metro):
    st, table = _system(n, rho, n_chains)
    chains = Chains(states=initialize_energy(st, table), table=table, list_type=list_type,
                    list_parameters=dict(params), n_chains=n_chains)
    algos = [
        dict(algorithm="Metropolis", pool=pool, seed=3, parallel_moves=parallel, **metro),
        dict(algorithm="StoreAcceptance", scheduler=[0, steps]),
    ]
    return Simulation(chains, algos, steps, path=str(tmp_path))


def _profiled(sim):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run()
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()]


def _inside(events, inner, outer):
    """Every `inner` range lies within some `outer` range of its thread."""
    outers = [(s, e, t) for name, s, e, t in events if name == outer]
    inners = [(s, e, t) for name, s, e, t in events if name == inner]
    assert inners and outers, (inner, outer)
    return all(any(os_ <= s and e <= oe and t == ot for os_, oe, ot in outers) for s, e, t in inners)


def test_span_is_a_shared_noop_without_the_profiler():
    assert not torch.autograd._profiler_enabled()
    before = tracing.totals()
    a, b = tracing.span("cb.block"), tracing.span("seq.step")
    assert a is b
    with a:
        pass
    assert tracing.totals() == before


def test_span_opens_the_profilers_cpp_range():
    """`span` relies on torch's private `torch._C._profiler._RecordFunctionFast`
    (the C++ range that record_function opens): a torch without it fails
    here, by name, and the range holds the ops run inside it."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test.span"):
            torch.ones(4).add_(1.0)
    events = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()]
    assert [name for name, *_ in events].count("test.span") == 1
    assert _inside(events, "aten::add_", "test.span")


@pytest.mark.parametrize("profiled", [False, True])
def test_phase_adds_one_call_per_use(profiled):
    name = f"test.phase.{profiled}"
    calls0, sec0 = tracing.totals().get(name, (0, 0.0))
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.phase(name):
                pass
        assert name in {e.name for e in prof.events()}
    else:
        with tracing.phase(name):
            pass
    with pytest.raises(KeyError):
        with tracing.phase(name):
            raise KeyError("a phase that raises still counts")
    calls, sec = tracing.totals()[name]
    assert calls == calls0 + 2 and sec >= sec0


def test_count_counters_and_reset():
    tracing.count("test.counter")
    tracing.count("test.counter", 4)
    got = tracing.counters()
    assert got["test.counter"] == 5
    got["test.counter"] = 0  # a copy
    assert tracing.counters()["test.counter"] == 5
    with tracing.phase("test.reset"):
        pass
    tracing.reset()
    assert tracing.counters() == {} and tracing.totals() == {}


def test_initialize_energy_is_one_phase():
    st, table = _system(64, 0.6, n_chains=2)
    calls0 = tracing.totals().get("setup.initialize_energy", (0, 0.0))[0]
    initialize_energy(st, table)
    calls, sec = tracing.totals()["setup.initialize_energy"]
    assert calls == calls0 + 1 and sec > 0.0


CB_SPANS = {
    "engine.chunk", "engine.sync", "engine.event.StoreAcceptance", "cb.block", "cb.rebin", "cb.host_copy", "cb.draws",
    "cb.substep", "cb.extract", "cb.trim", "cb.kernel", "cb.submove.double_uniform", "cb.write_back",
    "cb.counters", "cb.finish",
}


def test_checkerboard_run_spans(tmp_path):
    """A CPU checkerboard run with the kernel's Gaussian slots, a swap and
    the candidate compaction records every checkerboard span, each substep
    piece inside its substep, inside its block, inside the engine chunk, and
    launches nothing."""
    pool = (TMB.displacement(0.1, 0.8), TMB.discrete_swap(0, 1, 0.2))
    sim = _sim(tmp_path, True, "dense", {"inner": 2, "rebin_every": 2, "trim": 128}, pool, 140, 1.19, n_chains=2)
    assert sim.trim_k == 128
    launches = tracing.counters().get(LAUNCHES, 0)
    chunks = tracing.totals().get("engine.chunk", (0, 0.0))[0]
    copies = tracing.totals().get("cb.host_copy", (0, 0.0))[0]
    events = _profiled(sim)
    assert CB_SPANS <= {name for name, *_ in events}
    assert _inside(events, "cb.host_copy", "cb.rebin")
    assert _inside(events, "cb.extract", "cb.substep")
    assert _inside(events, "cb.kernel", "cb.substep")
    assert _inside(events, "cb.substep", "cb.block")
    assert _inside(events, "cb.rebin", "cb.block")
    assert _inside(events, "cb.block", "engine.chunk")
    assert _inside(events, "engine.sync", "engine.chunk")
    assert tracing.counters().get(LAUNCHES, 0) == launches  # CPU tensors never launch
    assert tracing.totals()["engine.chunk"][0] == chunks + 1
    # the block's copies from host memory: two in rebin, two per colour's bounds
    assert tracing.totals()["cb.host_copy"][0] == copies + 2 + 2 * 4
    assert not hasattr(sim, "sweep_seconds")  # the chunks' phase replaces it


def test_spatial_run_halo_span(tmp_path):
    """The slab backend's halo exchanges are `spatial.halo` spans inside the
    engine chunk, beside the substeps' spans."""
    pool = (TMB.displacement(0.1, 0.8), TMB.discrete_swap(0, 1, 0.2))
    sim = _sim(tmp_path, True, "dense", {"inner": 2, "rebin_every": 2}, pool, 140, 1.19, spatial_devices=2)
    assert sim.spatial_mesh is not None
    events = _profiled(sim)
    assert {"spatial.halo", "cb.substep", "cb.kernel"} <= {name for name, *_ in events}
    assert _inside(events, "spatial.halo", "engine.chunk")


SEQ_SPANS = {"engine.chunk", "engine.sync", "seq.draws", "seq.step", "seq.propose", "seq.delta_e", "seq.accept",
             "seq.cell_update"}


def test_sequential_run_spans(tmp_path):
    """A CPU run of the sequential kernel on its cell list records every
    sequential span, the ΔE and the cell update inside the step, inside the
    engine chunk."""
    with pytest.warns(UserWarning, match="cell-list"):
        sim = _sim(tmp_path, False, "cell", {"force_cells": True}, (TMB.displacement(0.1),), 100, 0.5,
                   n_chains=2, sweepstep=8)
    assert sim.neighbour_mode == "cell"
    events = _profiled(sim)
    assert SEQ_SPANS <= {name for name, *_ in events}
    assert _inside(events, "seq.delta_e", "seq.step")
    assert _inside(events, "seq.cell_update", "seq.step")
    assert _inside(events, "seq.step", "engine.chunk")
    assert _inside(events, "seq.draws", "engine.chunk")


def test_only_tracing_opens_profiler_ranges():
    """Every span of the port goes through tracing.py: no other file opens
    a profiler range, and the kernel wrapper keeps no launch attribute."""
    direct = []
    for d, _, files in os.walk(PKG):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py") and path != os.path.join(PKG, "tracing.py"):
                with open(path) as fh:
                    if re.search(r"\brecord_function\b|_RecordFunctionFast", fh.read()):
                        direct.append(os.path.relpath(path, PKG))
    assert direct == []
    assert not hasattr(cb_cuda.disp_substep, "launches")

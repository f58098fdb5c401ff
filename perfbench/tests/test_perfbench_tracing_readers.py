"""The readers of the program's own phases (host_issue_ms_per_sweep,
host_wait_ms_per_sweep, setup_energy_s) on hand-built slices: each gives
the hand-computed value, and None where its span is absent. The idle gaps
of such a slice are put down to the innermost program span over them."""

from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.trace import Trace

CELL = spec.cell("ka3d-n10k.cb-b16")


def read(metric, run):
    return spec.reader(CELL, metric).read(run)


def slice_with_phases():
    """Two engine chunks (0-1000 us, 2000-2600 us) with three synchronising
    calls inside them (100 + 50 + 30 us), one outside (40 us), a copy that
    blocks until its device-to-host copy has run (60 us), a host-to-device
    copy that is only queued, a device-to-device copy and a launch call,
    which are not waits; device work in two stretches."""
    host = [
        ("engine.chunk", 0.0, 1000.0),
        ("cb.block", 10.0, 990.0),
        ("cb.rebin", 20.0, 300.0),
        ("cudaStreamSynchronize", 100.0, 200.0),
        ("cudaLaunchKernel", 400.0, 405.0),
        ("cudaMemcpyAsync", 500.0, 560.0),
        ("cudaMemcpyAsync", 600.0, 606.0),
        ("cudaMemcpyAsync", 700.0, 705.0),
        ("engine.sync", 900.0, 990.0),
        ("cudaDeviceSynchronize", 920.0, 970.0),
        ("cudaStreamSynchronize", 1500.0, 1540.0),
        ("engine.chunk", 2000.0, 2600.0),
        ("cudaEventSynchronize", 2100.0, 2130.0),
    ]
    device = [
        ("kernel_a", 0.0, 50.0), ("kernel_b", 350.0, 900.0), ("kernel_c", 2000.0, 2500.0),
        ("Memcpy DtoH (Device -> Pageable)", 540.0, 545.0),
        ("Memcpy HtoD (Pageable -> Device)", 650.0, 652.0),
        ("Memcpy DtoD (Device -> Device)", 701.0, 703.0),
    ]
    return Trace(window_s=0.0026, device_ops=device, host_ops=host, stream_syncs=2)


@pytest.mark.parametrize("sweeps", [1.0, 4.0])
def test_host_issue_and_wait(sweeps):
    run = SimpleNamespace(trace=slice_with_phases(), sweeps=sweeps)
    # chunks 1000 + 600 us; waits inside them 100 + 60 + 50 + 30 us
    assert read("host_wait_ms_per_sweep", run) == pytest.approx(0.240 / sweeps)
    assert read("host_issue_ms_per_sweep", run) == pytest.approx((1.600 - 0.240) / sweeps)


@pytest.mark.parametrize(
    "copy, waited",
    [
        (("Memcpy DtoH (Device -> Pageable)", 130.0, 190.0), True),  # `.item()` behind queued work
        (("Memcpy HtoD (Pageable -> Device)", 195.0, 198.0), True),  # a staged copy the call waited for
        (("Memcpy HtoD (Pinned -> Device)", 230.0, 240.0), False),  # queued: runs after the call
        (("Memcpy DtoD (Device -> Device)", 150.0, 160.0), False),  # never between host and device
    ],
)
def test_a_copy_waits_when_its_copy_runs_inside_the_call(copy, waited):
    """A cudaMemcpyAsync call of 100 us inside the chunk is a wait exactly
    when a host-device copy ends inside it."""
    host = [("engine.chunk", 0.0, 1000.0), ("cudaMemcpyAsync", 100.0, 200.0)]
    device = [("kernel_a", 0.0, 180.0), copy]
    run = SimpleNamespace(trace=Trace(window_s=0.001, device_ops=device, host_ops=host, stream_syncs=0), sweeps=1.0)
    wait = 0.100 if waited else 0.0
    assert read("host_wait_ms_per_sweep", run) == pytest.approx(wait)
    assert read("host_issue_ms_per_sweep", run) == pytest.approx(1.0 - wait)


def test_host_readers_without_the_chunk_span():
    tr = slice_with_phases()
    tr.host_ops = [op for op in tr.host_ops if op[0] != "engine.chunk"]
    run = SimpleNamespace(trace=tr, sweeps=1.0)
    assert read("host_issue_ms_per_sweep", run) is None
    assert read("host_wait_ms_per_sweep", run) is None


def test_setup_energy_reads_the_phase(monkeypatch):
    from particlesmc_tpu_torch import tracing

    monkeypatch.setattr(tracing, "totals", lambda: {"setup.initialize_energy": (1, 17.25), "engine.chunk": (3, 9.0)})
    assert read("setup_energy_s", SimpleNamespace()) == 17.25
    monkeypatch.setattr(tracing, "totals", lambda: {"engine.chunk": (3, 9.0)})
    assert read("setup_energy_s", SimpleNamespace()) is None


def test_idle_gaps_take_the_innermost_span():
    """The gap 50-350 us lies under cb.rebin (its middle, 200 us, falls on
    the sync call, which labels only where no op covers it); 900-2000 us
    under nothing of the program at its middle (1450 us)."""
    gaps = dict(slice_with_phases().idle_gaps())
    assert gaps["cb.rebin"] == pytest.approx(300e-6)
    assert gaps["host outside any traced op"] == pytest.approx(1100e-6)

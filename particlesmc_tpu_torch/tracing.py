"""Spans and counters of the port, on the profiler's clock.

Three calls, imported by every layer:

- `span(name)`: a fine-grained span. Under an active torch.profiler it is a
  profiler range named `name`, which lands on the profiler's timeline
  beside the device kernels (`profile_dir` traces and any other profiled
  run hold it) as a host op, on the host's rows only. Otherwise it is one
  shared no-op context: one
  flag check, no allocation, nothing recorded.
- `phase(name)`: a coarse span (set-up, engine chunks and events: a few per
  output interval). It always adds one call and its host seconds
  (`time.perf_counter_ns`) to in-memory totals, and is a profiler range as
  `span` is when the profiler is on.
- `count(name, n=1)`: an always-on integer counter.

`totals()` gives {name: (calls, seconds)} of the phases, `counters()`
{name: int}, `reset()` clears both: the process's, updated from the one
thread that drives the engine. Nothing here reads a tensor, waits for a
device or launches work, so a span is harmless inside a CUDA graph
capture. Names used by the port (PERF.md §3 lists what reads each):

    setup.initialize_energy  setup.kernel_build  setup.kernel_load
    engine.chunk  engine.sync  engine.event.<algorithm>
    cb.block  cb.rebin  cb.host_copy  cb.draws  cb.substep  cb.extract  cb.trim
    cb.kernel  cb.submove.<kind>  cb.write_back  cb.counters  cb.finish
    spatial.halo
    seq.draws  seq.sweep_kernel  seq.step  seq.propose  seq.delta_e
    seq.accept  seq.cell_update
    counters: cb_cuda.launches  seq_cuda.launches  seq_cuda.steps
    seq_cuda.swap_launches  cb.submove_calls.<kind>
"""

from __future__ import annotations

import contextlib
import time

import torch

_profiler_enabled = torch.autograd._profiler_enabled
# the profiler's range in C++: the range `torch.profiler.record_function`
# opens, without its two dispatched ops (a tenth of its host cost under the
# profiler) and without a copy of the range on the device's timeline
_Range = torch._C._profiler._RecordFunctionFast
_NOOP = contextlib.nullcontext()
_totals: dict = {}  # name -> [calls, nanoseconds]
_counters: dict = {}  # name -> int


def span(name: str):
    """A profiler range named `name` when the profiler is on, else a shared
    no-op context."""
    if _profiler_enabled():
        return _Range(name)
    return _NOOP


@contextlib.contextmanager
def phase(name: str):
    """A span that also adds one call and its host seconds to `totals()`."""
    t0 = time.perf_counter_ns()
    try:
        with span(name):
            yield
    finally:
        entry = _totals.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += time.perf_counter_ns() - t0


def count(name: str, n: int = 1):
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """{phase name: (calls, host seconds)} since the last reset."""
    return {name: (calls, ns / 1e9) for name, (calls, ns) in _totals.items()}


def counters() -> dict:
    """{counter name: count} since the last reset."""
    return dict(_counters)


def reset():
    """Clear the phases' totals and the counters."""
    _totals.clear()
    _counters.clear()

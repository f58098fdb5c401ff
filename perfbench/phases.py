"""The program's own phases in a profiled slice (perfbench/trace.py's
Trace): its `tracing.phase` ranges are host ops of the slice, on the
profiler's clock, and the runtime calls inside them that return only once
the device has drained its queue up to them are its waits for the device.
A slice of a program without such a range has nothing to read (None).

The waits, by runtime call:
- cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize:
  every call;
- cudaMemcpyAsync, cudaMemcpy: a call during which a host-device copy
  (a device op named "Memcpy HtoD ..." or "Memcpy DtoH ...") ends, that is
  one that returned only after its copy had run behind the queued work (a
  copy to or from pageable host memory, as `.item()`, `.tolist()` and
  `torch.tensor(..., device=...)` make). A copy that the call only queued
  ends after it, and is issue.
Each wait counts whole, its own few microseconds of host work included.
"""

from __future__ import annotations

import bisect

CHUNK = "engine.chunk"  # Simulation._run_chunk: the sweeps between two events
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync", "cudaMemcpy")
HOST_DEVICE_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def waits(trace) -> list:
    """(start_us, end_us) of the host's runtime calls that waited for the
    device (the module's list)."""
    ends = sorted(e for name, _, e in trace.device_ops if name.startswith(HOST_DEVICE_COPIES))
    out = []
    for name, s, e in trace.host_ops:
        if name in SYNCS or (name in COPIES and bisect.bisect_left(ends, s) < bisect.bisect_right(ends, e)):
            out.append((s, e))
    return out


def split(trace, phase: str = CHUNK):
    """(issue_us, wait_us) of the `phase` ranges: their summed duration less
    the waits that lie inside them, and those waits' summed duration; None
    where the slice holds no such range."""
    ranges = [(s, e) for name, s, e in trace.host_ops if name == phase]
    if not ranges:
        return None
    wait = sum(e - s for s, e in waits(trace) if any(r0 <= s and e <= r1 for r0, r1 in ranges))
    return sum(e - s for s, e in ranges) - wait, wait

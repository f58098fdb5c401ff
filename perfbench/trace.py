"""A profiled slice of a run, reduced by the benchmark's own code (the
arithmetic of chip_smoke.py's `profile_block`): the device operations with
their names and times, the host's stream synchronisations, and the idle
gaps of the device labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# gaps labelled for the breakdown: the longest, by the host op under them
LABELLED_GAPS = 400
BREAKDOWN_ENTRIES = 10


@dataclass
class Trace:
    window_s: float  # wall time of the profiled slice
    device_ops: list  # (name, start_us, end_us) of the device's operations
    host_ops: list  # (name, start_us, end_us) of the host's ops and runtime calls
    stream_syncs: int
    busy_s: float = field(init=False)

    def __post_init__(self):
        self.busy_s = sum(e - s for _, s, e in self.device_ops) / 1e6

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name satisfies `match`."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) / 1e6

    def count(self, match) -> int:
        return sum(1 for name, _, _ in self.device_ops if match(name))

    def top_device_ops(self, k: int = BREAKDOWN_ENTRIES) -> list:
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return [[name[:120], sec] for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = BREAKDOWN_ENTRIES) -> list:
        """The device's idle gaps, summed by the innermost host op that
        covers each gap's middle (a runtime call only where no op does)."""
        ops = sorted(self.device_ops, key=lambda t: t[1])
        gaps, end = [], None
        for _, s, e in ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps = sorted(gaps, reverse=True)[:LABELLED_GAPS]
        hosts = sorted(self.host_ops, key=lambda t: t[1])
        starts = [s for _, s, _ in hosts]
        by_label = {}
        for dur, s, e in gaps:
            mid = 0.5 * (s + e)
            label, runtime = None, None
            for name, hs, he in reversed(hosts[: bisect.bisect_right(starts, mid)]):
                if he < mid:
                    continue
                if name.startswith("cuda") or name.startswith("cu"):
                    runtime = runtime or name
                    continue
                label = name
                break
            label = label or runtime or "host outside any traced op"
            by_label[label] = by_label.get(label, 0.0) + dur / 1e6
        return [[name[:120], sec] for name, sec in sorted(by_label.items(), key=lambda kv: -kv[1])[:k]]


def profile(fn) -> Trace:
    """Run `fn()` under torch.profiler (host and device) and reduce it.
    The device's own copies of the host's record_function ranges are
    annotations, not work, and are left out."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, syncs = [], [], 0
    for e in events:
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False) and e.name not in annotations:
                device_ops.append(span)
        else:
            host_ops.append(span)
            syncs += e.name == "cudaStreamSynchronize"
    if not device_ops:
        raise RuntimeError("the profiler saw no device activity in the slice")
    return Trace(window_s=window_s, device_ops=device_ops, host_ops=host_ops, stream_syncs=syncs)

"""Sampling schedules — the Arianna `build_schedule` contract (this
package's own copy of particlesmc_tpu/engine/schedule.py, numpy only).

Reconstructed semantics (SURVEY.md §1.2; call sites test/runtests.jl:47-48,
src/ParticlesMC.jl:255-261):
- `build_schedule(steps, burn, interval: int)` → linear times
  burn, burn+interval, ..., ≤ steps.
- `build_schedule(steps, burn, block: list)` → the block pattern (e.g.
  [0, 1, 2, 4, 8]) tiled every block[-1] steps starting at burn, clipped to
  ≤ steps.
- `build_schedule(steps, burn, base: float)` → geometric block
  0, 1, base, base², ... ≤ steps (the CLI builds a base-2 block via
  `build_schedule(interval, 0, 2.0)`, src/ParticlesMC.jl:256-258).

Returned as a sorted numpy int64 array of unique times.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np


def build_schedule(steps: int, burn: int, spec: Union[int, float, Iterable[int]]) -> np.ndarray:
    if isinstance(spec, (list, tuple, np.ndarray)):
        block = np.asarray(list(spec), np.int64)
        if block.size == 0:
            raise ValueError("empty block schedule")
        period = int(block[-1])
        if period <= 0:
            raise ValueError("block schedule must end with a positive period")
        times = []
        base = burn
        while base <= steps:
            for b in block:
                t = base + int(b)
                if t <= steps:
                    times.append(t)
            base += period
        return np.unique(np.asarray(times, np.int64))
    if isinstance(spec, float) and spec > 1.0:
        # geometric: 0, 1, b, b^2, ... ≤ steps
        times = [0, 1]
        t = spec
        while t <= steps:
            times.append(int(round(t)))
            t *= spec
        return np.unique(np.asarray(burn + np.asarray(times, np.int64), np.int64))
    interval = int(spec)
    if interval <= 0:
        raise ValueError("interval must be positive")
    return np.arange(burn, steps + 1, interval, dtype=np.int64)

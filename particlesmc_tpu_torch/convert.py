"""Build the port's objects from the JAX package's objects given as numpy
arrays, so that both packages can compute from identical parameters and
state. Nothing here imports the JAX package: callers pass plain arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.state import SystemState
from .models.tables import INT_FIELDS, PairTable
from .moves.checkerboard import CBState
from .runtime import resolve_device


def _float(a, dtype, device):
    return torch.tensor(np.asarray(a, np.float64)).to(device, dtype)


def table_from_numpy(fields: Dict[str, np.ndarray], dtype=torch.float64, device=None) -> PairTable:
    """A PairTable from {field name: [S, S] array} (every PairTable field)."""
    device = resolve_device(device)
    mats = {}
    for f in dataclasses.fields(PairTable):
        a = np.asarray(fields[f.name])
        if f.name in INT_FIELDS:
            mats[f.name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            mats[f.name] = _float(a, dtype, device)
    return PairTable(**mats)


def system_from_numpy(
    position, species, box, density, temperature, energy,
    dtype=torch.float64, energy_dtype=None, device=None,
) -> SystemState:
    """A batched SystemState from arrays with a leading chains axis:
    position [B, N, d], species [B, N] (0-based), box [B, d], density,
    temperature and energy [B]."""
    device = resolve_device(device)
    return SystemState(
        position=_float(position, dtype, device),
        species=torch.tensor(np.asarray(species, np.int64), device=device),
        box=_float(box, dtype, device),
        temperature=_float(temperature, dtype, device),
        density=_float(density, dtype, device),
        energy=_float(energy, energy_dtype or dtype, device),
    )


def cb_state_from_numpy(
    system: SystemState, planes, idx, slot, shift, attempted, accepted,
    overflow, skipped, seed: int = 0,
) -> CBState:
    """A CBState around `system` from batched checkerboard arrays: planes
    [B, d+1, cells, cap], idx [B, cells, cap], slot [B, n], shift [B, d],
    attempted/accepted [B, n_moves], overflow and skipped [B]. The generator
    is seeded with `seed` (JAX keys do not carry over)."""
    dev = system.position.device
    dt = system.position.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def i64(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)

    return CBState(
        system=system,
        generator=gen,
        shift=_float(shift, dt, dev),
        planes=_float(planes, dt, dev),
        idx=i64(idx),
        slot=i64(slot),
        attempted=i64(attempted),
        accepted=i64(accepted),
        overflow=torch.tensor(np.asarray(overflow, bool), device=dev),
        skipped=i64(skipped),
    )

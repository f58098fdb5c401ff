"""Build the port's objects from the JAX package's objects given as numpy
arrays, so that both packages can compute from identical parameters and
state. Nothing here imports the JAX package: callers pass plain arrays.

What carries across: every PairTable field (the pair parameters and the
FENE/LJ bond parameters), a system's positions, species, box, density,
temperature and energy ledger and, for a molecular system, its molecule ids
and padded bond lists, a checkerboard sampler's arrays (planes, including
the molecular planes, bins, counters) and a sequential sampler's counters
and cell list, and the pool's policy parameters. The random state does
not: JAX keys have no torch counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.neighbours import CellList
from .core.state import SystemState
from .models.tables import INT_FIELDS, PairTable
from .moves.checkerboard import CBState
from .moves.kernel import MCState
from .runtime import resolve_device


def _float(a, dtype, device):
    return torch.tensor(np.asarray(a, np.float64)).to(device, dtype)


def table_from_numpy(fields: Dict[str, np.ndarray], dtype=torch.float64, device=None) -> PairTable:
    """A PairTable from {field name: [S, S] array}: every PairTable field,
    the bond fields (has_bond, kr02, r02, eps4b, sigma2b, shiftb, rcut2b)
    included."""
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
    dtype=torch.float64, energy_dtype=None, device=None, molecule=None, bonds=None,
) -> SystemState:
    """A batched SystemState from arrays with a leading chains axis:
    position [B, N, d], species [B, N] (0-based), box [B, d], density,
    temperature and energy [B]; a molecular system also takes molecule
    [B, N] (0-based) and bonds [B, N, maxb] (partner ids, -1 padded)."""
    device = resolve_device(device)

    def i64(a):
        return None if a is None else torch.tensor(np.asarray(a, np.int64), device=device)

    return SystemState(
        position=_float(position, dtype, device),
        species=torch.tensor(np.asarray(species, np.int64), device=device),
        box=_float(box, dtype, device),
        temperature=_float(temperature, dtype, device),
        density=_float(density, dtype, device),
        energy=_float(energy, energy_dtype or dtype, device),
        molecule=i64(molecule),
        bonds=i64(bonds),
    )


def pool_params_from_numpy(params, dtype=torch.float64, device=None):
    """The pool's policy parameters (a tuple of dicts of tensors, as
    moves.base.init_pool_params makes them) from a tuple of dicts of
    arrays, such as the JAX package's."""
    device = resolve_device(device)
    return tuple({k: _float(v, dtype, device) for k, v in p.items()} for p in params)


def cb_state_from_numpy(
    system: SystemState, planes, idx, slot, shift, attempted, accepted,
    overflow, skipped, seed: int = 0,
) -> CBState:
    """A CBState around `system` from batched checkerboard arrays: planes
    [B, NP, cells, cap], idx [B, cells, cap], slot [B, n], shift [B, d],
    attempted/accepted [B, n_moves], overflow and skipped [B]. The generator
    is seeded with `seed` (JAX keys do not carry over)."""
    dev = system.position.device
    dt = system.position.dtype
    gen, i64 = _generator(dev, seed), _int64(dev)
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


def mc_state_from_numpy(
    system: SystemState, attempted, accepted, cell=None, seed: int = 0, flip_rounds: int = 0,
) -> MCState:
    """A sequential sampler's MCState around `system` from batched arrays:
    attempted/accepted [B, n_moves] and, in cell mode, `cell` = (bucket
    [B, ncells, cap], count [B, ncells], cell_of [B, N], overflow [B]).
    The generator is seeded with `seed` (JAX keys do not carry over)."""
    dev = system.position.device
    i64 = _int64(dev)
    clist = None
    if cell is not None:
        bucket, count, cell_of, overflow = cell
        clist = CellList(
            bucket=i64(bucket), count=i64(count), cell_of=i64(cell_of),
            overflow=torch.tensor(np.asarray(overflow, bool), device=dev),
        )
    return MCState(
        system=system, generator=_generator(dev, seed), cell=clist,
        attempted=i64(attempted), accepted=i64(accepted),
        flip_failed=torch.zeros(system.n_chains, dtype=torch.bool, device=dev),
        flip_rounds=int(flip_rounds),
    )


def _generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _int64(device):
    return lambda a: torch.tensor(np.asarray(a, np.int64), device=device)

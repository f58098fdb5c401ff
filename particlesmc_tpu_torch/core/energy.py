"""Total energy of a batch of chains (counterpart of
particlesmc_tpu/core/energy.py, atomic systems).

`total_energy_dense` is the O(N^2) oracle the incremental ledger is checked
against, and the start energy of every chain."""

from __future__ import annotations

import torch

from ..models.potentials import PAIR_FIELDS, pair_potential
from ..models.tables import PairTable, gather_pair
from .geometry import dist2

# elements of one [B, rows, N] pair buffer; bounds the memory of a chunk
_PAIR_BUDGET = 1 << 23


def total_energy_dense(position, species, box, table: PairTable, chunk: int = 256):
    """Total energy sum_i E_i / 2 per chain: position [B, N, d], species
    [B, N], box [B, d] -> [B]. Chunked over particles to bound the
    [B, rows, N] pair buffers."""
    B, n, _ = position.shape
    rows = max(1, min(chunk, n, _PAIR_BUDGET // max(1, B * n)))
    iota = torch.arange(n, device=position.device)
    pos_all = position[:, None, :, :]
    box_b = box[:, None, None, :]
    per = []
    for k0 in range(0, n, rows):
        k1 = min(n, k0 + rows)
        xk = position[:, k0:k1, None, :]
        r2 = dist2(pos_all, xk, box_b)  # [B, rows, N]
        p = gather_pair(table, species[:, k0:k1, None], species[:, None, :], PAIR_FIELDS)
        u = pair_potential(r2, p)
        valid = iota[None, None, :] != iota[k0:k1, None][None]
        per.append(torch.sum(torch.where(valid, u, torch.zeros_like(u)), dim=-1))
    return torch.sum(torch.cat(per, dim=1), dim=-1) / 2


def initialize_energy(state, table: PairTable, check: bool = True, energy_dtype=None):
    """Compute and store each chain's start energy; reject a configuration
    whose energy is infinite or NaN. `energy_dtype` widens the stored ledger
    (mixed precision: float32 positions with a float64 ledger, since an f32
    accumulator at |E| ~ 3e4 rounds each booked ΔE at ~2e-3)."""
    if energy_dtype is None:
        e = total_energy_dense(state.position, state.species, state.box, table)
    else:  # the start of a wider ledger is computed at its width
        e = total_energy_dense(
            state.position.to(energy_dtype), state.species,
            state.box.to(energy_dtype), table.astype(energy_dtype),
        )
    if check and not bool(torch.isfinite(e).all()):
        raise ValueError("Initial configuration has infinite or NaN energy.")
    return state.replace(energy=e)

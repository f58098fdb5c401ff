"""Energies of a batch of chains (counterpart of particlesmc_tpu/core/energy.py).

`total_energy_dense` is the O(N^2) oracle the incremental ledger is checked
against, and the start energy of every chain. On molecular systems each
particle's sum excludes its bonded partners from the non-bonded pairs and
adds the bond terms over its bond list."""

from __future__ import annotations

import torch

from ..models.potentials import PAIR_FIELDS, bond_potential, pair_potential
from ..models.tables import BOND_FIELDS, PairTable, gather_pair
from .geometry import dist2

# elements of one [B, rows, N] pair buffer; bounds the memory of a chunk
_PAIR_BUDGET = 1 << 23


def per_particle_energies(position, species, box, table: PairTable, bonds=None, chunk: int = 256):
    """Every particle's energy against all others: position [B, N, d],
    species [B, N], box [B, d], bonds [B, N, maxb] or None -> [B, N].
    Chunked over particles to bound the [B, rows, N] pair buffers."""
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
        sk = species[:, k0:k1, None]
        p = gather_pair(table, sk, species[:, None, :], PAIR_FIELDS)
        u = pair_potential(r2, p)
        valid = iota[None, None, :] != iota[k0:k1, None][None]
        if bonds is not None:
            bk = bonds[:, k0:k1]  # [B, rows, maxb]
            valid = valid & ~torch.any(iota[None, None, :, None] == bk[:, :, None, :], dim=-1)
        e = torch.sum(torch.where(valid, u, torch.zeros_like(u)), dim=-1)
        if bonds is not None:
            bvalid = bk >= 0
            partner = torch.where(bvalid, bk, torch.zeros_like(bk))
            xb = torch.gather(position, 1, partner.reshape(B, -1, 1).expand(-1, -1, position.shape[-1]))
            r2b = dist2(xb.reshape(partner.shape + (-1,)), xk, box_b)  # [B, rows, maxb]
            sb = torch.gather(species, 1, partner.reshape(B, -1)).reshape(partner.shape)
            ub = bond_potential(r2b, gather_pair(table, sk, sb, BOND_FIELDS))
            e = e + torch.sum(torch.where(bvalid, ub, torch.zeros_like(ub)), dim=-1)
        per.append(e)
    return torch.cat(per, dim=1)


def total_energy_dense(position, species, box, table: PairTable, bonds=None, chunk: int = 256):
    """Total energy sum_i E_i / 2 per chain -> [B] (per_particle_energies)."""
    return torch.sum(per_particle_energies(position, species, box, table, bonds, chunk), dim=-1) / 2


def initialize_energy(state, table: PairTable, check: bool = True, energy_dtype=None):
    """Compute and store each chain's start energy; reject a configuration
    whose energy is infinite or NaN. `energy_dtype` widens the stored ledger
    (mixed precision: float32 positions with a float64 ledger, since an f32
    accumulator at |E| ~ 3e4 rounds each booked ΔE at ~2e-3)."""
    if energy_dtype is None:
        e = total_energy_dense(state.position, state.species, state.box, table, state.bonds)
    else:  # the start of a wider ledger is computed at its width
        e = total_energy_dense(
            state.position.to(energy_dtype), state.species,
            state.box.to(energy_dtype), table.astype(energy_dtype), state.bonds,
        )
    if check and not bool(torch.isfinite(e).all()):
        raise ValueError("Initial configuration has infinite or NaN energy.")
    return state.replace(energy=e)

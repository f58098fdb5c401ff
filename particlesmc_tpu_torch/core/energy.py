"""Energies of a batch of chains (counterpart of particlesmc_tpu/core/energy.py).

`total_energy_dense` is the O(N^2) oracle the incremental ledger is checked
against, and the start energy of every chain. On molecular systems each
particle's sum excludes its bonded partners from the non-bonded pairs and
adds the bond terms over its bond list.

The sequential kernel's per-particle energies take rows: particle ids
k [B, R], each row with its own `Override`, a virtual single-move edit
(particle i at pos_i with species sp_i, particle j with species sp_j)
applied during the evaluation in place of the reference's
mutate-then-recompute. `particle_energy` sums over candidate ids
[B, R, M] (-1 padded, a cell list's), `particle_energy_nogather` over all N
particles (the dense ΔE).

`pressure` is the virial pressure rho T + W / (d V), W the total pair and
bond virial (`total_virial_dense`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..models.potentials import (
    bond_potential,
    bond_virial,
    pair_fields_needed,
    pair_potential,
    pair_virial,
)
from ..models.tables import BOND_FIELDS, PairTable, gather_pair
from .geometry import dist2

# elements of one [B, rows, N] pair buffer; bounds the memory of a chunk
_PAIR_BUDGET = 1 << 23


class Override(NamedTuple):
    """Virtual single-move edit per row: i [B, R] takes position pos_i
    [B, R, d] and species sp_i, j [B, R] takes species sp_j (j == i for a
    displacement). i = j = -1 is no edit (candidate padding is -1 too, but
    padded lanes are masked before the edit can matter)."""

    i: torch.Tensor
    j: torch.Tensor
    pos_i: torch.Tensor
    sp_i: torch.Tensor
    sp_j: torch.Tensor


def no_override(k, position) -> Override:
    """The empty edit for rows shaped like k [B, R]."""
    i = torch.full_like(k, -1)
    z = torch.zeros_like(k)
    return Override(i, i, position.new_zeros(k.shape + position.shape[-1:]), z, z)


def take(x, idx):
    """x[b, idx[b, ...]] for x [B, N, *t] and ids idx [B, *s] ->
    [B, *s, *t]; a negative id reads row 0 (its lane is masked by the
    caller)."""
    B = x.shape[0]
    flat = torch.clamp_min(idx.reshape(B, -1), 0)
    t = x.shape[2:]
    if t:
        flat = flat.reshape((B, -1) + (1,) * len(t)).expand((B, flat.shape[1]) + t)
    return torch.gather(x, 1, flat).reshape(idx.shape + t)


def _effective(idx, position, species, ov: Override):
    """Positions and species of particles idx [B, R, ...] with each row's
    edit applied."""
    x = take(position, idx)
    s = take(species, idx)
    extra = (1,) * (idx.dim() - ov.i.dim())
    oi, oj = ov.i.reshape(ov.i.shape + extra), ov.j.reshape(ov.j.shape + extra)
    hit_i = idx == oi
    x = torch.where(hit_i[..., None], ov.pos_i.reshape(ov.i.shape + extra + ov.pos_i.shape[-1:]), x)
    s = torch.where(hit_i, ov.sp_i.reshape(oi.shape), s)
    s = torch.where(idx == oj, ov.sp_j.reshape(oj.shape), s)
    return x, s


def _bonded_sum(k, xk, sk, position, species, box, table, bonds, ov):
    """Σ over k's bond list of the bond potential [B, R], with the edit."""
    bonds_k = take(bonds, k)  # [B, R, maxb]
    bvalid = bonds_k >= 0
    xb, sb = _effective(torch.where(bvalid, bonds_k, 0), position, species, ov)
    r2b = dist2(xb, xk[..., None, :], box[:, None, None, :])
    ub = bond_potential(r2b, gather_pair(table, sk[..., None], sb, BOND_FIELDS))
    return torch.sum(torch.where(bvalid, ub, 0.0), dim=-1)


def particle_energy(
    k, cands, position, species, box, table: PairTable, bonds=None,
    ov: Optional[Override] = None, kinds=None,
):
    """Energy [B, R] of particles k [B, R] against candidate ids cands
    [B, R, M] (-1 padded): the non-bonded pair sum over candidates other
    than k and its bonded partners, plus the bond terms over k's bond list.
    Inf propagates (an overlap, an overstretched FENE bond) so that the
    Metropolis step rejects. `kinds` (tables.kinds_present) prunes the
    potential forms."""
    if ov is None:
        ov = no_override(k, position)
    xk, sk = _effective(k, position, species, ov)
    xc, sc = _effective(cands, position, species, ov)
    valid = (cands >= 0) & (cands != k[..., None])
    if bonds is not None:
        bonds_k = take(bonds, k)
        valid = valid & ~torch.any(cands[..., None] == bonds_k[..., None, :], dim=-1)
    r2 = dist2(xc, xk[..., None, :], box[:, None, None, :])
    u = pair_potential(r2, gather_pair(table, sk[..., None], sc, pair_fields_needed(kinds)), kinds)
    e = torch.sum(torch.where(valid, u, 0.0), dim=-1)
    if bonds is not None:
        e = e + _bonded_sum(k, xk, sk, position, species, box, table, bonds, ov)
    return e


def particle_energy_nogather(
    k, position, species, box, table: PairTable, bonds=None,
    ov: Optional[Override] = None, kinds=None,
):
    """Energy [B, R] of particles k [B, R] against all N particles, each row
    with its own edit applied to the whole configuration: the same sums as
    particle_energy(k, arange(N), ...)."""
    B, n, d = position.shape
    iota = torch.arange(n, device=position.device)
    if ov is None:
        ov = no_override(k, position)
    hit_i = iota == ov.i[..., None]  # [B, R, N]
    pos_eff = torch.where(hit_i[..., None], ov.pos_i[:, :, None, :], position[:, None])
    sp_eff = torch.where(
        hit_i, ov.sp_i[..., None], torch.where(iota == ov.j[..., None], ov.sp_j[..., None], species[:, None])
    )
    R = k.shape[1]
    xk = torch.gather(pos_eff, 2, k[:, :, None, None].expand(B, R, 1, d))[:, :, 0]
    sk = torch.gather(sp_eff, 2, k[:, :, None])[:, :, 0]
    valid = iota != k[..., None]
    if bonds is not None:
        bonds_k = take(bonds, k)
        valid = valid & ~torch.any(iota[:, None] == bonds_k[..., None, :], dim=-1)
    r2 = dist2(pos_eff, xk[:, :, None, :], box[:, None, None, :])
    u = pair_potential(r2, gather_pair(table, sk[..., None], sp_eff, pair_fields_needed(kinds)), kinds)
    e = torch.sum(torch.where(valid, u, 0.0), dim=-1)
    if bonds is not None:
        e = e + _bonded_sum(k, xk, sk, position, species, box, table, bonds, ov)
    return e


def particle_energy_dense(k, position, species, box, table: PairTable, bonds=None, ov=None, kinds=None):
    """O(N) particle energies over all candidates: the dense oracle."""
    B, n = species.shape
    cands = torch.arange(n, device=position.device).expand(k.shape + (n,))
    return particle_energy(k, cands, position, species, box, table, bonds, ov, kinds)


def per_particle_energies(
    position, species, box, table: PairTable, bonds=None, chunk: int = 256, cand_fn=None,
    kinds=None,
):
    """Every particle's energy against all others: position [B, N, d],
    species [B, N], box [B, d], bonds [B, N, maxb] or None -> [B, N].
    With `cand_fn(k [B, R]) -> cands [B, R, M]` each particle sums over its
    candidates (particle_energy) instead of all N. Chunked over particles to
    bound the pair buffers; `kinds` prunes the potential forms."""
    B, n, _ = position.shape
    rows = max(1, min(chunk, n, _PAIR_BUDGET // max(1, B * n)))
    iota = torch.arange(n, device=position.device)
    if cand_fn is not None:
        per = []
        for k0 in range(0, n, rows):
            k = iota[k0:k0 + rows].expand(B, -1)
            per.append(particle_energy(k, cand_fn(k), position, species, box, table, bonds, kinds=kinds))
        return torch.cat(per, dim=1)
    pos_all = position[:, None, :, :]
    box_b = box[:, None, None, :]
    per = []
    for k0 in range(0, n, rows):
        k1 = min(n, k0 + rows)
        xk = position[:, k0:k1, None, :]
        r2 = dist2(pos_all, xk, box_b)  # [B, rows, N]
        sk = species[:, k0:k1, None]
        p = gather_pair(table, sk, species[:, None, :], pair_fields_needed(kinds))
        u = pair_potential(r2, p, kinds)
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


def per_particle_energies_of(position, species, box, table: PairTable, bonds=None, cand_fn=None, kinds=None):
    """per_particle_energies of Q species assignments on each chain's
    positions: species [B, Q, N] -> [B, Q, N]. The distances (and, with
    `cand_fn`, the candidates) are computed once per chain and shared by its
    Q assignments; the pair buffers [B, Q, rows, M] are chunked over
    particles within _PAIR_BUDGET elements."""
    B, n, _ = position.shape
    Q = species.shape[1]
    iota = torch.arange(n, device=position.device)
    width = n if cand_fn is None else None
    box_b = box[:, None, None, :]
    per = []
    k0 = 0
    while k0 < n:
        if width is None:  # the candidates' width, from a one-row call
            width = cand_fn(iota[:1].expand(B, 1)).shape[-1]
        rows = max(1, min(n - k0, _PAIR_BUDGET // max(1, B * Q * width)))
        k = iota[k0:k0 + rows].expand(B, -1)  # [B, R]
        xk = position[:, k0:k0 + rows, None, :]
        sk = species[:, :, k0:k0 + rows, None]  # [B, Q, R, 1]
        if cand_fn is None:
            cands = iota
            r2 = dist2(position[:, None], xk, box_b)  # [B, R, N]
            sc = species[:, :, None, :]
            valid = iota != k[..., None]
        else:
            cands = cand_fn(k)  # [B, R, M]
            r2 = dist2(take(position, cands), xk, box_b)
            flat = torch.clamp_min(cands, 0).reshape(B, 1, -1).expand(B, Q, -1)
            sc = torch.gather(species, 2, flat).reshape((B, Q) + cands.shape[1:])
            valid = (cands >= 0) & (cands != k[..., None])
        if bonds is not None:
            bk = bonds[:, k0:k0 + rows]  # [B, R, maxb]
            valid = valid & ~torch.any(cands[..., None] == bk[:, :, None, :], dim=-1)
        u = pair_potential(r2[:, None], gather_pair(table, sk, sc, pair_fields_needed(kinds)), kinds)
        e = torch.sum(torch.where(valid[:, None], u, 0.0), dim=-1)  # [B, Q, R]
        if bonds is not None:
            bvalid = bk >= 0
            partner = torch.clamp_min(bk, 0)
            r2b = dist2(take(position, partner), xk, box_b)  # [B, R, maxb]
            flat = partner.reshape(B, 1, -1).expand(B, Q, -1)
            sb = torch.gather(species, 2, flat).reshape((B, Q) + partner.shape[1:])
            ub = bond_potential(r2b[:, None], gather_pair(table, sk, sb, BOND_FIELDS))
            e = e + torch.sum(torch.where(bvalid[:, None], ub, 0.0), dim=-1)
        per.append(e)
        k0 += rows
    return torch.cat(per, dim=2)


def total_energy_dense(position, species, box, table: PairTable, bonds=None, chunk: int = 256):
    """Total energy sum_i E_i / 2 per chain -> [B] (per_particle_energies)."""
    return torch.sum(per_particle_energies(position, species, box, table, bonds, chunk), dim=-1) / 2


def particle_virial_nogather(k, position, species, box, table: PairTable, bonds=None, kinds=None):
    """Virial W_k = Σ_j w(r_kj) [B, R] of particles k [B, R] against all N
    particles: the non-bonded pair virial over every other particle except
    k's bonded partners, plus the bond virial over k's bond list."""
    B, n, _ = position.shape
    iota = torch.arange(n, device=position.device)
    xk = take(position, k)  # [B, R, d]
    sk = take(species, k)
    valid = iota != k[..., None]
    if bonds is not None:
        bonds_k = take(bonds, k)
        valid = valid & ~torch.any(iota[:, None] == bonds_k[..., None, :], dim=-1)
    r2 = dist2(position[:, None], xk[:, :, None, :], box[:, None, None, :])
    w = pair_virial(r2, gather_pair(table, sk[..., None], species[:, None], pair_fields_needed(kinds)), kinds)
    out = torch.sum(torch.where(valid, w, torch.zeros_like(w)), dim=-1)
    if bonds is not None:
        bvalid = bonds_k >= 0
        partner = torch.clamp_min(bonds_k, 0)
        r2b = dist2(take(position, partner), xk[..., None, :], box[:, None, None, :])
        wb = bond_virial(r2b, gather_pair(table, sk[..., None], take(species, partner), BOND_FIELDS))
        out = out + torch.sum(torch.where(bvalid, wb, torch.zeros_like(wb)), dim=-1)
    return out


def total_virial_dense(position, species, box, table: PairTable, bonds=None, chunk: int = 256, kinds=None):
    """W = Σ_{i<j} w_ij per chain -> [B], as Σ_k W_k / 2 over chunks of
    particles (particle_virial_nogather) within _PAIR_BUDGET elements."""
    B, n, _ = position.shape
    rows = max(1, min(chunk, n, _PAIR_BUDGET // max(1, B * n)))
    iota = torch.arange(n, device=position.device)
    per = [
        particle_virial_nogather(iota[k0:k0 + rows].expand(B, -1), position, species, box, table, bonds, kinds)
        for k0 in range(0, n, rows)
    ]
    return torch.sum(torch.cat(per, dim=1), dim=-1) / 2


def pressure(position, species, box, table: PairTable, density, temperature, bonds=None):
    """Virial pressure per chain P = rho T + W / (d V) -> [B]."""
    d = position.shape[-1]
    vol = torch.prod(box, dim=-1)
    w = total_virial_dense(position, species, box, table, bonds)
    return density * temperature + w / (d * vol)


def initialize_energy(state, table: PairTable, check: bool = True, energy_dtype=None):
    """Compute and store each chain's start energy; reject a configuration
    whose energy is infinite or NaN. `energy_dtype` widens the stored ledger
    (mixed precision: float32 positions with a float64 ledger, since an f32
    accumulator at |E| ~ 3e4 rounds each booked ΔE at ~2e-3)."""
    with tracing.phase("setup.initialize_energy"):
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

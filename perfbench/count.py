"""The yardstick of the checkerboard displacement sub-moves: the operations
and bytes one sub-move needs, counted from a state (positions, species,
box), the published potential and the cell's parameters alone.

A sub-move picks a particle of an active cell, proposes x + N(0, sigma^2)
per dimension, and needs its energy change only when the proposal stays in
the cell. The energy change needs, for each other particle of the mover's
3^d neighbourhood of cells, two squared distances (3d - 1 operations each),
two cutoff compares, the subtract and its accumulate; and the potential's
body (the form's BODY_OPS) for each pair within the cutoff, at the old and
at the new position. The cells are the grid that the cutoff sets (side >=
the largest cutoff, an even count per dimension), under no shift.

The count reads nothing of the program: not its packed lanes, their
padding or compaction, nor its accepts. A program that changes how it lays
out or skips lanes leaves the count as it is.

Bytes: each input of a colour substep read once and each output written
once: every particle's position and species, the sub-moves' draws (the
pick, d normals and the acceptance uniform), the moved cells' positions, an
accept flag per sub-move and an energy change per cell.

H100 SXM data-sheet peaks (dense, outside the tensor cores) and HBM rate;
they assume the card's full power limit of 700 W.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.energy import pair_blocks, pair_tables, squared_distances

PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12


def grid(box_side: float, rcut: float, d: int):
    """Cells per dimension: the most with side >= rcut, rounded down to even."""
    nc = int(math.floor(box_side / rcut))
    nc -= nc % 2
    return (nc,) * d


def max_cutoff(potential: dict) -> float:
    sig = potential["sigma"]
    return float(potential["rcut_over_sigma"]) * max(max(row) for row in sig)


def submove_cost(position, species, box, potential: dict, sigma: float, inner: int, dtype=torch.float32):
    """(operations, bytes) per attempted sub-move, averaged over the chains
    of `position` [B, N, d]: a sub-move is charged its cell's mean over the
    cell's particles (each equally likely to be picked), and every cell
    counts alike (each active cell gets the same sub-moves); an empty cell
    needs nothing. Also returns the parts of the count."""
    B, n, d = position.shape
    dev = position.device
    L = float(box[0, 0])
    nc = grid(L, max_cutoff(potential), d)[0]
    side = L / nc
    f, tab = pair_tables(potential, dev)
    S = tab["eps4"].shape[0]
    x = position.double() - torch.floor(position.double() / L) * L
    cvec = torch.clamp(torch.floor(x / side).long(), 0, nc - 1)  # [B, N, d]
    cell = torch.zeros((B, n), dtype=torch.int64, device=dev)
    for k in range(d):
        cell = cell * nc + cvec[..., k]
    n_cells = nc**d
    occ = torch.zeros((B, n_cells), dtype=torch.int64, device=dev).scatter_add_(1, cell, torch.ones_like(cell))
    # particles in each cell's 3^d neighbourhood (periodic)
    occ_grid = occ.reshape((B,) + (nc,) * d)
    block = torch.zeros_like(occ_grid)
    for off in torch.cartesian_prod(*[torch.tensor([-1, 0, 1])] * d).reshape(-1, d).tolist():
        block += torch.roll(occ_grid, shifts=off, dims=tuple(range(1, d + 1)))
    block = block.reshape(B, n_cells)
    # probability that the proposal stays in the mover's cell
    lo = cvec.double() * side
    z_hi = (lo + side - x) / (sigma * math.sqrt(2.0))
    z_lo = (lo - x) / (sigma * math.sqrt(2.0))
    stay = (0.5 * (torch.erf(z_hi) - torch.erf(z_lo))).prod(dim=-1)  # [B, N]
    # body operations of the pairs within the cutoff, per particle
    body = torch.zeros((B, n), dtype=torch.float64, device=dev)
    for cs, rs in pair_blocks(B, n):
        r2 = squared_distances(position, box, cs, rs)
        pair = species[cs, rs, None] * S + species[cs, None, :]
        body[cs, rs] = (r2 <= tab["rcut2"].reshape(-1)[pair]).sum(dim=-1).double()
    body = body * f.BODY_OPS
    per_lane = 2 * (3 * d - 1) + 4
    m_block = torch.gather(block, 1, cell).double()  # the mover's neighbourhood
    ops_i = stay * ((m_block - 1.0) * per_lane + 2.0 * body)  # [B, N]
    ops_cell = torch.zeros((B, n_cells), dtype=torch.float64, device=dev).scatter_add_(1, cell, ops_i)
    mean_cell = torch.where(occ > 0, ops_cell / occ.clamp_min(1), torch.zeros_like(ops_cell))
    ops = float(mean_cell.sum() / (occ > 0).sum())  # per sub-move of an occupied cell
    # bytes of one colour substep over its active cells' sub-moves
    e = torch.finfo(dtype).bits // 8
    C = 2**d
    per_substep_inputs = n * (d + 1) * e  # positions and species
    per_substep_outputs = (n / C) * d * e + (n_cells / C) * 8  # moved cells, energy changes
    per_submove = (d + 2) * e + 1  # draws in, accept flag out
    nbytes = per_submove + (per_substep_inputs + per_substep_outputs) / (n_cells / C * inner)
    return ops, nbytes, {
        "cells": [nc] * d, "mean_stay": float(stay.mean()), "mean_block": float(block.double().mean()),
        "mean_body_pairs": float(body.mean()) / f.BODY_OPS,
    }


def least_seconds(ops: float, nbytes: float, dtype):
    """The least time the card could take: (seconds, bound)."""
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

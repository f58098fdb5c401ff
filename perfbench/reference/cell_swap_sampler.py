"""The plain reference sampler for pools of Gaussian displacements and
DoubleUniform swaps whose partners are picked within one cell of a grid:
sequential Metropolis, one move per chain per step, float64 by default, as
the checkerboard's docstring and the reference ParticlesMC (src/moves.jl:
34-123 Displacement + SimpleGaussian, :137-214 DiscreteSwap, :226-241
DoubleUniform) define the moves, with the swap's partners drawn in one cell
as the checkerboard draws them.

Each step every chain picks one move of the pool with the pool's
probabilities:
- `displacement` (sigma): particle i uniform over all N, moved by sigma
  times a standard normal vector and folded into the box; its energy
  change against every other particle; symmetric (reference/sampler.py's
  move).
- `discrete_swap` (s1, s2; policy `double_uniform`), the in-cell proposal:
  the box is cut into the grid that the cutoff sets (per dimension the most
  cells of side >= the largest pair cutoff, rounded down to an even count;
  one cell where the box is under two cutoffs wide), under an origin shift
  drawn uniform over the box at every step; one cell is drawn uniform over
  all cells, and i uniform among its particles of species s1, j among its
  particles of species s2; the two exchange their species. A cell that lacks
  either species rejects. Given the cell's members, the proposal picks the
  pair with probability 1 / (n1 n2) both ways (the swap keeps the cell's
  composition), so there is no Hastings term.

The energy change of a swap is that of the pairs of i and of j with every
other particle: E_i + E_j after less before, the i-j pair's own term the
same either way. The squared distances are taken in the positions' type and
the potential evaluated in `compute`, the ledger kept in float64; each step
costs O(N) pair terms per chain.

Its acceptance per move, in float64 from a state of the window (cell.py's
`acceptance_span`), is what the program's acceptance of each move is judged
against (`acceptance`, which cell.py finds by the traffic's
`reference_sampler`). It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.energy import pair_tables, total_energy
from perfbench.reference.swap_sampler import moves_of


def cells_per_side(box_side: float, rcut: float) -> int:
    """The most cells of side >= rcut, rounded down to an even count; 1
    where the box is under two cutoffs wide."""
    nc = int(math.floor(box_side / rcut))
    nc -= nc % 2
    return max(1, nc)


# steps whose draws are made at once
DRAW_CHUNK = 1024


def metropolis(position, species, box, temperature, potential, pool, steps, generator, compute=torch.float64):
    """`steps` sequential Metropolis steps of every chain with the traffic's
    `pool` at `temperature` [B]; returns the positions, the species, the
    float64 ledger's start and end, and the attempted and accepted moves per
    chain and move of the pool, [B, M].

    Each step evaluates four pair sums per chain, one particle at one
    species against every other particle: a displacement's particle at its
    new and its old position (the last two weigh 0), or a swap's i as s2 and
    as s1 and its j as s1 and as s2, each without i and j. The draws of
    DRAW_CHUNK steps are made at once: per step six uniforms (the move, the
    displaced particle, the cell, the two partners, the test), d normals and
    the grid's shift."""
    B, n, d = position.shape
    dev = position.device
    f, tab = pair_tables(potential, dev)
    S = tab["eps4"].shape[0]
    rcut = float(tab["rcut2"].max().sqrt())
    names = list(tab)
    coef = torch.stack([tab[k].reshape(-1) for k in names], dim=-1).to(compute)  # [S*S, fields]
    for mv in pool:
        if mv["move"] == "discrete_swap" and mv["args"].get("policy", "double_uniform") != "double_uniform":
            raise NotImplementedError(f"the cell swap sampler runs DoubleUniform swaps, not {mv}")
    P = moves_of(pool, dev)
    M = P["kind"].shape[0]
    x, sp = position.clone(), species.clone()
    L = box.to(x.dtype)[:, None, :]
    nc = [cells_per_side(float(side), rcut) for side in box[0].tolist()]
    nc_t = torch.tensor(nc, dtype=torch.int64, device=dev)
    side = L / nc_t.to(x.dtype)
    strides = torch.tensor([math.prod(nc[k + 1:]) for k in range(d)], dtype=torch.int64, device=dev)
    ncells = math.prod(nc)
    ledger0 = total_energy(x, sp, box, potential)
    ledger = ledger0.clone()
    rows = torch.arange(B, device=dev)
    cols = torch.arange(n, device=dev)
    beta = 1.0 / temperature.double()
    moves = torch.arange(M, device=dev)
    attempted = torch.zeros((B, M), dtype=torch.int64, device=dev)
    accepted = torch.zeros((B, M), dtype=torch.int64, device=dev)
    for t0 in range(0, int(steps), DRAW_CHUNK):
        k = min(DRAW_CHUNK, int(steps) - t0)
        U = torch.rand((k, B, 6), generator=generator, device=dev, dtype=torch.float64)
        G = torch.randn((k, B, d), generator=generator, device=dev, dtype=x.dtype)
        SH = torch.rand((k, B, 1, d), generator=generator, device=dev, dtype=x.dtype) * L
        m_all = (U[..., 0, None] >= P["cum"]).sum(dim=-1)  # [k, B]
        swap_all = P["kind"][m_all] == 1
        step_all = P["sigma"][m_all].to(x.dtype)[..., None] * G
        s1_all, s2_all = P["s1"][m_all], P["s2"][m_all]
        i_all = torch.floor(U[..., 1] * n).long()
        c_all = torch.floor(U[..., 2] * ncells).long()
        log_u_all = torch.log(U[..., 5])
        acc_all = torch.zeros((k, B), dtype=torch.bool, device=dev)
        for t in range(k):
            swap, s1, s2 = swap_all[t], s1_all[t], s2_all[t]
            # the displacement's particle and proposal
            i_d = i_all[t]
            x_i = x[rows, i_d]
            x_new = x_i + step_all[t]
            x_new = x_new - torch.floor(x_new / L[:, 0]) * L[:, 0]
            # the swap's cell under this step's shift, and its partners
            cell = ((torch.floor((x + SH[t]) / side).long() % nc_t) * strides).sum(dim=-1)  # [B, N]
            member = (cell == c_all[t][:, None])[:, None, :] & (sp[:, None, :] == torch.stack((s1, s2), 1)[..., None])
            count = member.sum(dim=-1)  # [B, 2]
            rank = torch.floor(U[t, :, 3:5] * count.double()).long()
            pick = torch.argmax((member & (torch.cumsum(member.long(), dim=-1) - 1 == rank[..., None])).int(), dim=-1)
            i_s, j_s = pick[:, 0], pick[:, 1]
            # four pair sums: (i at x_new, i at x_i) or (i as s2, i as s1,
            # j as s1, j as s2)
            i = torch.where(swap, i_s, i_d)
            j = torch.where(swap, j_s, i_d)
            s_i = sp[rows, i]
            x_is, x_js = x[rows, i], x[rows, j]
            y = torch.stack((torch.where(swap[:, None], x_is, x_new), x_is, x_js, x_js), 1)  # [B, 4, d]
            sy = torch.stack((torch.where(swap, s2, s_i), torch.where(swap, s1, s_i), s1, s2), 1)  # [B, 4]
            others = ((cols != i[:, None]) & (cols != j[:, None]))[:, None, :]  # [B, 1, N]
            dx = x[:, None] - y[:, :, None]
            dx = dx - torch.round(dx / L[:, None]) * L[:, None]
            r2 = (dx * dx).sum(dim=-1).to(compute)  # [B, 4, N]
            cf = coef[sy[..., None] * S + sp[:, None, :]]  # [B, 4, N, fields]
            u = f.energy(torch.where(others, r2, torch.ones_like(r2)), {name: cf[..., q] for q, name in enumerate(names)})
            e = torch.where(others, u, torch.zeros_like(u)).sum(dim=-1).double()  # [B, 4]
            de = (e[:, 0] - e[:, 1]) + torch.where(swap, e[:, 2] - e[:, 3], torch.zeros_like(e[:, 2]))
            valid = ~swap | (count > 0).all(dim=-1)
            accept = valid & (log_u_all[t] < -de * beta)
            acc_all[t] = accept
            ledger += torch.where(accept, de, torch.zeros_like(de))
            x[rows, i_d] = torch.where((accept & ~swap)[:, None], x_new, x_i)
            swapped = accept & swap
            sp[rows, i] = torch.where(swapped, s2, s_i)
            sp[rows, j] = torch.where(swapped, s1, sp[rows, j])
        hit = m_all[..., None] == moves  # [k, B, M]
        attempted += hit.sum(dim=0)
        accepted += (hit & acc_all[..., None]).sum(dim=0)
    return x, sp, ledger0, ledger, attempted, accepted


def acceptance(cfg: dict, trf: dict, position, species, box, steps: int, generator):
    """([attempted], [accepted]) per move of the traffic's pool, summed
    over the chains: `steps` float64 steps from `position` and `species`
    at the configuration's temperature."""
    B = position.shape[0]
    temp = torch.full((B,), float(cfg["system"]["temperature"]), dtype=torch.float64, device=position.device)
    *_, att, acc = metropolis(position.double(), species, box.double(), temp, cfg["potential"], trf["pool"],
                              int(steps), generator, compute=torch.float64)
    return att.sum(dim=0).tolist(), acc.sum(dim=0).tolist()

"""The plain reference sampler: sequential Metropolis with Gaussian
displacements. Each step every chain moves one particle picked uniformly,
with the energy change summed over all other particles; the squared
distances are taken in the positions' type and the potential is evaluated
in `compute`, the ledger kept in float64.

Two uses: in float64 from the window's end state, its acceptance is what
the program's acceptance is judged against (`acceptance`, which cell.py
finds by the traffic's `reference_sampler`); in bfloat16 from the set-up's
end it is the control put in the program's place (control.py), its ledger
judged by the same drift as the program's.
"""

from __future__ import annotations

import torch

from perfbench.reference.energy import pair_tables, total_energy


def particle_energy(x, i_pos, i, species, box, f, tab, S, compute):
    """[B] energy of one particle per chain at positions i_pos [B, d]
    against every other particle of x [B, N, d], evaluated in `compute`."""
    B, n, _ = x.shape
    L = box[:, None, :]
    dx = x - i_pos[:, None, :]
    dx = dx - torch.round(dx / L) * L
    r2 = (dx * dx).sum(dim=-1).to(compute)
    s_i = species.gather(1, i[:, None])
    pair = s_i * S + species
    c = {k: v.reshape(-1)[pair] for k, v in tab.items()}
    u = f.energy(torch.where(r2 > 0, r2, torch.ones_like(r2)), c)
    others = torch.arange(n, device=x.device)[None, :] != i[:, None]
    return torch.where(others, u, torch.zeros_like(u)).sum(dim=-1)


def metropolis(position, species, box, temperature, potential, sigma, steps, generator,
               compute=torch.bfloat16):
    """`steps` sequential Metropolis steps of every chain at `temperature`
    [B]; returns the positions, the float64 ledger's start and end, and the
    attempted and accepted moves per chain."""
    B, n, d = position.shape
    dev = position.device
    f, tab = pair_tables(potential, dev)
    S = tab["eps4"].shape[0]
    tab = {k: v.to(compute) for k, v in tab.items()}
    x = position.clone()
    L = box.to(x.dtype)
    ledger0 = total_energy(x, species, box, potential)
    ledger = ledger0.clone()
    rows = torch.arange(B, device=dev)
    accepted = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(int(steps)):
        i = torch.randint(n, (B,), generator=generator, device=dev)
        x_i = x[rows, i]
        x_new = x_i + sigma * torch.randn((B, d), generator=generator, device=dev, dtype=x.dtype)
        x_new = x_new - torch.floor(x_new / L) * L
        de = (particle_energy(x, x_new, i, species, L, f, tab, S, compute)
              - particle_energy(x, x_i, i, species, L, f, tab, S, compute)).double()
        u = torch.rand(B, generator=generator, device=dev, dtype=torch.float64)
        accept = torch.log(u) < -de / temperature.double()
        ledger += torch.where(accept, de, torch.zeros_like(de))
        x[rows, i] = torch.where(accept[:, None], x_new, x_i)
        accepted += accept
    return x, ledger0, ledger, torch.full((B,), int(steps), dtype=torch.int64, device=dev), accepted


def acceptance(cfg: dict, trf: dict, position, species, box, steps: int, generator):
    """(attempted, accepted) summed over the chains: `steps` float64 steps
    from `position` at the configuration's temperature, for a traffic whose
    pool is Gaussian displacements of one sigma."""
    kinds = {(m["move"], m["args"].get("sigma")) for m in trf["pool"]}
    if len(kinds) != 1 or next(iter(kinds))[0] != "displacement":
        raise NotImplementedError(f"this sampler runs a pool of one displacement, not {trf['pool']}")
    B = position.shape[0]
    temp = torch.full((B,), float(cfg["system"]["temperature"]), dtype=torch.float64, device=position.device)
    sigma = float(trf["pool"][0]["args"]["sigma"])
    _, _, _, att, acc = metropolis(position.double(), species, box.double(), temp, cfg["potential"], sigma,
                                   int(steps), generator, compute=torch.float64)
    return int(att.sum()), int(acc.sum())

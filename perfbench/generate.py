"""The start of every chain, made on the device from the run's seed (a copy
of the lattice starts of chip_smoke.py's `lattice_config`, `bench_system`
and `scenario_config`): a cubic lattice filling the box (N / rho)^(1/d), each
site moved by a uniform perturbation of +-`perturb` lattice spacings, the
species in the configuration's exact fractions in an order drawn from the
seed, and each chain's own uniform jitter of +-`chain_jitter` / 2 spacings.

Every seed gives the same sizes and composition: only the order of the
species and the perturbations change.
"""

from __future__ import annotations

import torch


def lattice_sites(n: int, d: int) -> int:
    """The smallest k with k^d >= n."""
    k = 1
    while k**d < n:
        k += 1
    return k


def species_counts(n: int, fractions) -> list:
    counts = [round(n * f) for f in fractions]
    counts[-1] = n - sum(counts[:-1])
    return counts


def start(system: dict, start_cfg: dict, chains: int, seed: int, device) -> dict:
    """Float64 positions [B, N, d] folded into the box, 0-based int64
    species [B, N] (one order for every chain), and the box side."""
    n, d, rho = int(system["n"]), int(system["dim"]), float(system["density"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    L = (n / rho) ** (1.0 / d)
    k = lattice_sites(n, d)
    a = L / k
    axis = torch.arange(k, dtype=torch.float64, device=device) * a + a / 2
    sites = torch.stack(torch.meshgrid(*[axis] * d, indexing="ij"), -1).reshape(-1, d)[:n]
    perturb = float(start_cfg["perturb"])
    pos = sites + (torch.rand((n, d), generator=g, dtype=torch.float64, device=device) * 2 - 1) * perturb * a
    order = torch.randperm(n, generator=g, device=device)
    fill = torch.cat([
        torch.full((c,), s, dtype=torch.int64, device=device)
        for s, c in enumerate(species_counts(n, system["species_fractions"]))
    ])
    species = fill[order]
    jitter = torch.rand((chains, n, d), generator=g, dtype=torch.float64, device=device) - 0.5
    pos = pos[None] + jitter * float(start_cfg["chain_jitter"]) * a
    pos = pos - torch.floor(pos / L) * L
    return {"position": pos, "species": species.expand(chains, n).contiguous(), "box_side": L}

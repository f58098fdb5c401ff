"""The benchmark's plain reference: each chain's total potential energy,
sum over pairs i < j of u(r_ij) under the minimum image, in float64, dense
over all pairs in blocks of rows.

It imports nothing of the program under test and takes nothing the program
made: the pair parameters come from the configuration file's `potential`
through a frozen form under forms/, found by the form's name; the positions
and species it judges are read as plain tensors.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

FORMS = Path(__file__).resolve().parent / "forms"
# pairs of one block: bounds the [chains, rows, N, d] buffers (2^24 pairs
# are 400 MB of float64 displacements in 3D)
PAIR_BLOCK = 1 << 24


def form(name: str):
    """The pair-potential module forms/<name>.py (BODY_OPS, coefficients,
    energy)."""
    path = FORMS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference form {name!r} under {FORMS}")
    spec = importlib.util.spec_from_file_location(f"perfbench_form_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair_tables(potential: dict, device) -> tuple:
    """(form module, {field: [S, S] float64 tensor on `device`})."""
    f = form(potential["form"])
    return f, {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in f.coefficients(potential).items()}


def pair_blocks(n_chains: int, n: int):
    """(chain slice, row slice) blocks that cover [n_chains, n] rows of an
    all-pairs sweep within PAIR_BLOCK pairs each."""
    rows = max(1, min(n, PAIR_BLOCK // n))
    chains = max(1, PAIR_BLOCK // (rows * n))
    for b0 in range(0, n_chains, chains):
        for r0 in range(0, n, rows):
            yield slice(b0, min(n_chains, b0 + chains)), slice(r0, min(n, r0 + rows))


def squared_distances(position, box, cs, rs):
    """r^2 [chains, rows, N] of the block's rows against every particle
    (minimum image), float64; each row's own pair is +inf."""
    x = position[cs].double()
    L = box[cs].double()[:, None, None, :]
    dx = x[:, rs, None, :] - x[:, None, :, :]
    dx = dx - torch.round(dx / L) * L
    r2 = (dx * dx).sum(dim=-1)
    rows = torch.arange(rs.start, rs.stop, device=x.device)
    self_pair = rows[:, None] == torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(self_pair, torch.full_like(r2, float("inf")), r2)


def total_energy(position, species, box, potential: dict) -> torch.Tensor:
    """[B] float64 total energy of each chain: position [B, N, d], species
    [B, N] (0-based), box [B, d]."""
    B, n, _ = position.shape
    f, tab = pair_tables(potential, position.device)
    S = tab["eps4"].shape[0]
    out = torch.zeros(B, dtype=torch.float64, device=position.device)
    for cs, rs in pair_blocks(B, n):
        r2 = squared_distances(position, box, cs, rs)
        pair = species[cs, rs, None] * S + species[cs, None, :]
        c = {k: v.reshape(-1)[pair] for k, v in tab.items()}
        out[cs] += f.energy(r2, c).sum(dim=(1, 2))
    return out / 2.0

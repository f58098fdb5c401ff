"""Cut and shifted Lennard-Jones pair (Kob & Andersen, Phys. Rev. E 51, 4626):

    u(r) = 4 eps [(sigma/r)^12 - (sigma/r)^6] - u_cut   for r <= rcut,  else 0,

with rcut = rcut_over_sigma * sigma and u_cut the unshifted value at rcut.
A frozen copy for the benchmark's reference: it shares no code with the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

# operations of the potential's body past its cutoff compare: clamp, divide,
# x^3 (2), x^6 (1), subtract and times 4 eps (7), minus the shift (8)
BODY_OPS = 8


def coefficients(potential: dict) -> dict:
    """[S, S] float64 arrays of the pair parameters."""
    eps = np.asarray(potential["eps"], np.float64)
    sigma = np.asarray(potential["sigma"], np.float64)
    rcut = float(potential["rcut_over_sigma"]) * sigma
    sigma2, rcut2 = sigma * sigma, rcut * rcut
    x3 = (sigma2 / rcut2) ** 3
    shift = 4.0 * eps * (x3 * x3 - x3) if potential.get("shifted", True) else np.zeros_like(eps)
    return {"eps4": 4.0 * eps, "sigma2": sigma2, "rcut2": rcut2, "shift": shift}


def energy(r2: torch.Tensor, c: dict) -> torch.Tensor:
    """u(r2) for per-pair coefficients `c` gathered to r2's shape; 0 past rcut."""
    x3 = (c["sigma2"] / r2) ** 3
    u = c["eps4"] * (x3 * x3 - x3) - c["shift"]
    return torch.where(r2 <= c["rcut2"], u, torch.zeros_like(u))

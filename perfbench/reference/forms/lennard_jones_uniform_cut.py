"""Lennard-Jones pair with one cutoff for every pair (the binary mixture of
Rowley et al., doi:10.1023/A:1022614200488, as the reference ParticlesMC's
examples/lj-mixture runs it):

    u(r) = 4 eps [(sigma/r)^12 - (sigma/r)^6] - u_cut   for r <= rcut,  else 0,

with u_cut the unshifted value of the pair at rcut where `shifted` is true,
else 0. The one cutoff is stated as rcut = rcut_over_sigma * max(sigma),
the product that perfbench/count.py's `max_cutoff` reads: for a cutoff of
4 sigma_1 with sigma_BB = 1.0640, rcut_over_sigma = 4.0 / 1.0640. Unlike
forms/lennard_jones.py, whose cutoff is rcut_over_sigma times each pair's
own sigma, every pair here is cut at the same distance.

A frozen copy for the benchmark's reference: it shares no code with the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

# operations of the potential's body past its cutoff compare, as
# forms/lennard_jones.py counts them: clamp, divide, x^3 (2), x^6 (1),
# subtract and times 4 eps (7), minus the shift (8), which is 0 unshifted
BODY_OPS = 8


def coefficients(potential: dict) -> dict:
    """[S, S] float64 arrays of the pair parameters."""
    eps = np.asarray(potential["eps"], np.float64)
    sigma = np.asarray(potential["sigma"], np.float64)
    rcut = float(potential["rcut_over_sigma"]) * float(sigma.max())
    sigma2 = sigma * sigma
    rcut2 = np.full_like(sigma, rcut * rcut)
    x3 = (sigma2 / rcut2) ** 3
    shift = 4.0 * eps * (x3 * x3 - x3) if potential["shifted"] else np.zeros_like(eps)
    return {"eps4": 4.0 * eps, "sigma2": sigma2, "rcut2": rcut2, "shift": shift}


def energy(r2: torch.Tensor, c: dict) -> torch.Tensor:
    """u(r2) for per-pair coefficients `c` gathered to r2's shape; 0 past rcut."""
    x3 = (c["sigma2"] / r2) ** 3
    u = c["eps4"] * (x3 * x3 - x3) - c["shift"]
    return torch.where(r2 <= c["rcut2"], u, torch.zeros_like(u))

"""Smoothed Lennard-Jones pair of the JBB ternary model (Jung, Biroli &
Berthier; the reference ParticlesMC's `SmoothLennardJones`):

    u(r) = 4 eps [(sigma/r)^12 - (sigma/r)^6 + C0 + C2 (r/sigma)^2 + C4 (r/sigma)^4]

for r <= rcut = rcut_over_sigma * sigma, else 0; C0, C2, C4 make u and u'
vanish at rcut = 2.5 sigma. A frozen copy for the benchmark's reference: it
shares no code with the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

# operations of the potential's body past its cutoff compare: the LJ core
# (clamp, divide, x^3, x^6, subtract, times 4 eps: 7) plus the smoothing
# polynomial, its factor and the add (6)
BODY_OPS = 13


def coefficients(potential: dict) -> dict:
    """[S, S] float64 arrays of the pair parameters."""
    eps = np.asarray(potential["eps"], np.float64)
    sigma = np.asarray(potential["sigma"], np.float64)
    c0, c2, c4 = (float(potential["smoothing"][k]) for k in ("C0", "C2", "C4"))
    sigma2 = sigma * sigma
    rcut = float(potential["rcut_over_sigma"]) * sigma
    return {
        "eps4": 4.0 * eps, "sigma2": sigma2, "rcut2": rcut * rcut,
        "c0": np.full_like(eps, c0), "c2s2": c2 / sigma2, "c4s4": c4 / (sigma2 * sigma2),
    }


def energy(r2: torch.Tensor, c: dict) -> torch.Tensor:
    """u(r2) for per-pair coefficients `c` gathered to r2's shape; 0 past rcut."""
    x3 = (c["sigma2"] / r2) ** 3
    u = c["eps4"] * (x3 * x3 - x3 + c["c0"] + r2 * (c["c2s2"] + r2 * c["c4s4"]))
    return torch.where(r2 <= c["rcut2"], u, torch.zeros_like(u))

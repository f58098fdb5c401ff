"""Move pool specification (counterpart of particlesmc_tpu/moves/base.py).

A `Move` couples an action (what changes) with a policy (how it is proposed)
and a probability. The spec is static; the tunable policy parameters live in
a separate tuple of dicts of tensors, one dict per move.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..runtime import resolve_device

VALID = {
    "displacement": ("gaussian", "smart"),
    "swap": ("double_uniform", "energy_bias"),
    "flip": ("double_uniform",),
}


@dataclasses.dataclass(frozen=True)
class Move:
    """Static move spec. `species` is the 0-based species pair for 'swap'."""

    action: str
    policy: str
    probability: float
    species: Optional[Tuple[int, int]] = None
    params: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.action not in VALID:
            raise ValueError(f"Unsupported action: {self.action}")
        if self.policy not in VALID[self.action]:
            raise ValueError(f"Unsupported policy: {self.policy} for action: {self.action}")
        if self.action == "swap" and (self.species is None or len(self.species) != 2):
            raise ValueError("'species' for action swap must be a pair")


def displacement(sigma: float, probability: float = 1.0) -> Move:
    """Displacement with a SimpleGaussian proposal of width `sigma`."""
    return Move("displacement", "gaussian", probability, params=(("sigma", float(sigma)),))


def displacement_smart(sigma: float, probability: float = 1.0) -> Move:
    """Force-bias ("smart MC") displacement: delta = clamp(sigma^2/(2T) F(x))
    + sigma xi with the exact Metropolis-Hastings asymmetry correction.
    Checkerboard atomic pools only."""
    return Move("displacement", "smart", probability, params=(("sigma", float(sigma)),))


def discrete_swap(
    s1: int, s2: int, probability: float, policy: str = "double_uniform",
    theta1: float = 0.0, theta2: float = 0.0,
) -> Move:
    """Species swap of a pair of 0-based species; the energy_bias policy
    picks each partner with probability proportional to exp(theta E)."""
    params = (("theta1", float(theta1)), ("theta2", float(theta2))) if policy == "energy_bias" else ()
    return Move("swap", policy, probability, species=(int(s1), int(s2)), params=params)


def molecule_flip(probability: float) -> Move:
    """Exchange of the species of two sites of one molecule."""
    return Move("flip", "double_uniform", probability)


def init_pool_params(pool, dtype=torch.float64, device=None):
    """Initial policy parameters: a tuple of dicts of tensors, one per move,
    on `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    return tuple(
        {k: torch.tensor(v, dtype=torch.float64).to(device, dtype) for k, v in m.params}
        for m in pool
    )


def pool_probabilities(pool, dtype=torch.float64, device=None):
    p = torch.tensor([m.probability for m in pool], dtype=dtype, device=resolve_device(device))
    return p / torch.sum(p)

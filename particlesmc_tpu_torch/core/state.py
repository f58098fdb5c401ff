"""Batched system state (counterpart of particlesmc_tpu/core/state.py).

Every tensor has a leading chains axis B: the JAX package vmaps one chain's
state over chains, while a hand-written kernel needs the batch written out.
Atomic systems only; molecular fields come with ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class SystemState:
    """B Markov chains of one particle system.

    - position [B, N, d] (float), species [B, N] (int64, 0-based)
    - box [B, d], temperature [B], density [B] (float)
    - energy [B]: the incremental energy ledger; float64 under mixed
      precision (float32 positions), else the position dtype
    """

    position: torch.Tensor
    species: torch.Tensor
    box: torch.Tensor
    temperature: torch.Tensor
    density: torch.Tensor
    energy: torch.Tensor

    @property
    def n_chains(self) -> int:
        return self.position.shape[0]

    @property
    def n_particles(self) -> int:
        return self.position.shape[-2]

    @property
    def dim(self) -> int:
        return self.position.shape[-1]

    def replace(self, **kw) -> "SystemState":
        return dataclasses.replace(self, **kw)

    def repeat(self, n_chains: int) -> "SystemState":
        """n_chains copies of a one-chain state."""
        if self.n_chains != 1:
            raise ValueError("repeat expects a one-chain state")
        return SystemState(
            **{
                f.name: getattr(self, f.name).repeat(
                    (n_chains,) + (1,) * (getattr(self, f.name).dim() - 1)
                )
                for f in dataclasses.fields(self)
            }
        )


def make_system(
    position,
    species,
    density,
    temperature,
    *,
    box=None,
    dtype=torch.float64,
    device=None,
) -> SystemState:
    """Build a SystemState from [N, d] (one chain) or [B, N, d] positions.

    `species` may be 1-based as in config files: each chain's species are
    shifted to 0-based when their minimum is 1. The box defaults to the
    cubic (N/rho)^(1/d) box. `density` and `temperature` are scalars or one
    value per chain. The state lives on `device`: the card unless the caller
    names another. Energy is left at 0; call energy.initialize_energy.
    """
    device = resolve_device(device)
    position = np.asarray(position, np.float64)
    if position.ndim == 2:
        position = position[None]
    B, n, d = position.shape
    species = np.asarray(species)
    species = np.broadcast_to(species if species.ndim == 2 else species[None], (B, n))
    species = species - (species.min(axis=1, keepdims=True) >= 1)  # per chain
    density = np.broadcast_to(np.asarray(density, np.float64), (B,))
    temperature = np.broadcast_to(np.asarray(temperature, np.float64), (B,))
    if box is None:
        box = (n / density[:, None]) ** (1.0 / d) * np.ones((B, d))
    box = np.broadcast_to(np.asarray(box, np.float64), (B, d))

    def f(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float64).to(device, dtype)

    return SystemState(
        position=f(position),
        species=torch.tensor(np.ascontiguousarray(species), dtype=torch.int64, device=device),
        box=f(box),
        temperature=f(temperature),
        density=f(density),
        energy=torch.zeros(B, dtype=dtype, device=device),
    )

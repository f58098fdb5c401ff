"""Batched system state (counterpart of particlesmc_tpu/core/state.py).

Every tensor has a leading chains axis B: the JAX package vmaps one chain's
state over chains, while a hand-written kernel needs the batch written out.
Molecular systems fill the optional `molecule` / `bonds` fields (bond lists
padded to a static maximum degree with -1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..runtime import resolve_device
from . import geometry


@dataclasses.dataclass(frozen=True)
class SystemState:
    """B Markov chains of one particle system.

    - position [B, N, d] (float), species [B, N] (int64, 0-based)
    - box [B, d], temperature [B], density [B] (float)
    - energy [B]: the incremental energy ledger; float64 under mixed
      precision (float32 positions), else the position dtype
    - molecule [B, N] (int64, 0-based molecule id) and bonds [B, N, maxb]
      (int64 partner ids, -1 padded) for molecular systems; None for atoms
    """

    position: torch.Tensor
    species: torch.Tensor
    box: torch.Tensor
    temperature: torch.Tensor
    density: torch.Tensor
    energy: torch.Tensor
    molecule: Optional[torch.Tensor] = None
    bonds: Optional[torch.Tensor] = None

    @property
    def n_chains(self) -> int:
        return self.position.shape[0]

    @property
    def n_particles(self) -> int:
        return self.position.shape[-2]

    @property
    def dim(self) -> int:
        return self.position.shape[-1]

    @property
    def is_molecular(self) -> bool:
        return self.bonds is not None

    def replace(self, **kw) -> "SystemState":
        return dataclasses.replace(self, **kw)

    def repeat(self, n_chains: int) -> "SystemState":
        """n_chains copies of a one-chain state."""
        if self.n_chains != 1:
            raise ValueError("repeat expects a one-chain state")
        out = {}
        for f in dataclasses.fields(self):
            t = getattr(self, f.name)
            out[f.name] = None if t is None else t.repeat((n_chains,) + (1,) * (t.dim() - 1))
        return SystemState(**out)


def make_system(
    position,
    species,
    density,
    temperature,
    *,
    molecule=None,
    bonds=None,
    box=None,
    dtype=torch.float64,
    device=None,
) -> SystemState:
    """Build a SystemState from [N, d] (one chain) or [B, N, d] positions.

    `species` may be 1-based as in config files: each chain's species are
    shifted to 0-based when their minimum is 1. The box defaults to the
    cubic (N/rho)^(1/d) box. `density` and `temperature` are scalars or one
    value per chain. A molecular system also takes `molecule` ([N] or
    [B, N], shifted to 0-based like species) and `bonds` (per-particle
    partner lists, see pad_bonds; one chain's, shared by all). The state
    lives on `device`: the card unless the caller names another. Energy is
    left at 0; call energy.initialize_energy.
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

    def i64(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)

    mol = bnd = None
    if molecule is not None:
        mol = np.asarray(molecule)
        mol = np.broadcast_to(mol if mol.ndim == 2 else mol[None], (B, n))
        mol = i64(mol - (mol.min(axis=1, keepdims=True) >= 1))
    if bonds is not None:
        bnd = pad_bonds(bonds, n)
        bnd = i64(np.broadcast_to(bnd if bnd.ndim == 3 else bnd[None], (B,) + bnd.shape[-2:]))
    return SystemState(
        position=f(position),
        species=i64(species),
        box=f(box),
        temperature=f(temperature),
        density=f(density),
        energy=torch.zeros(B, dtype=dtype, device=device),
        molecule=mol,
        bonds=bnd,
    )


def pad_bonds(bonds, n: int) -> np.ndarray:
    """Per-particle bond lists (0-based partner ids) as a padded [N, maxb]
    int64 array with -1 fill (maxb >= 1), each list sorted. An array of two
    or more dimensions is taken as already padded."""
    if isinstance(bonds, (np.ndarray, torch.Tensor)) and bonds.ndim >= 2:
        return np.asarray(bonds.cpu() if isinstance(bonds, torch.Tensor) else bonds, np.int64)
    maxb = max(1, max((len(b) for b in bonds), default=0))
    out = np.full((n, maxb), -1, np.int64)
    for i, bl in enumerate(bonds):
        out[i, : len(bl)] = sorted(bl)
    return out


def bonds_from_pairs(pairs, n: int):
    """Per-particle bond lists from (i, j) pairs (0-based)."""
    adj = [[] for _ in range(n)]
    for i, j in pairs:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    return adj


def mol_table(molecule):
    """(start, length) per molecule for consecutive-run molecule ids, as
    numpy int32 arrays."""
    molecule = np.asarray(molecule)
    change = np.flatnonzero(np.diff(molecule)) + 1
    starts = np.concatenate([[0], change])
    lengths = np.diff(np.concatenate([starts, [len(molecule)]]))
    return starts.astype(np.int32), lengths.astype(np.int32)


def shared_box(box) -> bool:
    """Whether every chain's box [B, d] is allclose to chain 0's (numpy's
    default tolerances, as the JAX engine tests it), so that the chains can
    share one static grid, which is built from chain 0's box."""
    return torch.allclose(box, box[:1].expand_as(box))


class ChainBlock(NamedTuple):
    """A shard's place in the global batch: its chains are rows [lo, hi) of
    `total`. A sampler state of a shard carries its block, and every draw is
    made at the global batch's shape and cut to these rows, so that a shard
    draws for its chains what the unsharded run draws for them and the
    shards' generators stay in step (parallel/mesh.py::shard_chains)."""

    lo: int
    hi: int
    total: int


def draw_batch(block: Optional[ChainBlock], n_chains: int) -> int:
    """The batch size a draw is made at: the global one on a shard."""
    return n_chains if block is None else block.total


def own_rows(x, block: Optional[ChainBlock]):
    """The shard's rows of a draw (or of fed-in draws) at the global shape."""
    return x if block is None else x[block.lo:block.hi]


def fold_positions(state: SystemState) -> SystemState:
    """Fold all positions into the primary box."""
    return state.replace(position=geometry.fold_back(state.position, state.box[:, None, :]))

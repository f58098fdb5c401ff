"""Parallel tempering (counterpart of particlesmc_tpu/engine/tempering.py).

The temperature ladder lives on the chains axis: chain k holds temperature
T_k. A swap attempt between neighbours (k, k+1) accepts when

    log u < (β_k − β_{k+1})(E_k − E_{k+1})

and exchanges configurations (positions, species, energy ledger and the
sampler's per-chain arrays: the cell list of MCState, the grid arrays of
CBState), while temperatures, move counters and the generator stay with the
slot. Even and odd neighbour pairs alternate per pass.
"""

from __future__ import annotations

import dataclasses

import torch

# per-chain fields that stay with the slot when configurations move
_SLOT_FIELDS = ("temperature", "attempted", "accepted")


def _permute(obj, perm):
    """`obj` (a dataclass state) with every chain-axis tensor gathered by
    `perm`, except the slot's fields; nested states likewise."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _SLOT_FIELDS:
            continue
        if dataclasses.is_dataclass(v):
            kw[f.name] = _permute(v, perm)
        elif isinstance(v, torch.Tensor):
            kw[f.name] = v[perm]
    return dataclasses.replace(obj, **kw)


def replica_exchange(mc, parity: int, u=None, generator=None):
    """One replica-exchange pass over a batched sampler state (MCState or
    CBState) with M chains. `u` [M] gives the acceptance uniforms; otherwise
    they are drawn from `generator`. Returns (mc, attempted [M] bool,
    accepted [M] bool), where entry k refers to the pair (k, k+1)."""
    st = mc.system
    E = st.energy
    M = E.shape[0]
    dt = E.dtype
    beta = 1.0 / st.temperature
    idx = torch.arange(M, device=E.device)
    is_left = (idx % 2 == parity) & (idx + 1 < M)
    log_alpha = (beta - torch.roll(beta, -1)) * (E - torch.roll(E, -1))
    if u is None:
        u = torch.clamp_min(torch.rand(M, generator=generator, dtype=dt, device=E.device), torch.finfo(dt).tiny)
    accept = is_left & (torch.log(u) < log_alpha)
    accept_right = torch.roll(accept, 1)  # entry k: swaps with k - 1
    perm = torch.where(accept, idx + 1, torch.where(accept_right, idx - 1, idx))
    return _permute(mc, perm), is_left, accept


class ReplicaExchange:
    """Engine-facing wrapper: scheduled passes with acceptance counts. Its
    generator lives on the chains' device."""

    def __init__(self, sim, seed: int = 0):
        self.sim = sim
        self.generator = torch.Generator(device=sim.mc.system.energy.device)
        self.generator.manual_seed(int(seed) ^ 0x5EED)
        self._parity = 0
        self.attempted = 0
        self.accepted = 0

    def step(self):
        mc, att, acc = replica_exchange(self.sim.mc, self._parity, generator=self.generator)
        self.sim.mc = mc
        self._parity ^= 1
        self.attempted += int(att.sum())
        self.accepted += int(acc.sum())

    @property
    def rate(self) -> float:
        return self.accepted / self.attempted if self.attempted else 0.0

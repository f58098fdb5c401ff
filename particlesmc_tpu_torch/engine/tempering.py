"""Parallel tempering (counterpart of particlesmc_tpu/engine/tempering.py).

The temperature ladder lives on the chains axis: chain k holds temperature
T_k. A swap attempt between neighbours (k, k+1) accepts when

    log u < (β_k − β_{k+1})(E_k − E_{k+1})

and exchanges configurations (positions, species, energy ledger and the
sampler's per-chain arrays: the cell list of MCState, the grid arrays of
CBState), while temperatures, move counters and the generator stay with the
slot. Even and odd neighbour pairs alternate per pass. Under chain sharding
(parallel/mesh.py) the pass is global: a swap may cross a shard boundary.
"""

from __future__ import annotations

import dataclasses

import torch

# per-chain fields that stay with the slot when configurations move
_SLOT_FIELDS = ("temperature", "attempted", "accepted")


def _permute(objs, take, p: int = 0):
    """`objs[p]` (a dataclass state) with every chain-axis tensor replaced
    by `take` of that field in each of `objs` (one state, or every chain
    shard's), except the slot's fields; nested states likewise."""
    obj = objs[p]
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _SLOT_FIELDS:
            continue
        if dataclasses.is_dataclass(v):
            kw[f.name] = _permute([getattr(o, f.name) for o in objs], take, p)
        elif isinstance(v, torch.Tensor):
            kw[f.name] = take([getattr(o, f.name) for o in objs])
    return dataclasses.replace(obj, **kw)


def _swap_perm(E, temperature, parity: int, u, generator):
    """The pass's permutation [M] of configurations over the M slots, and
    attempted / accepted [M] (entry k for the pair (k, k+1))."""
    M = E.shape[0]
    dt = E.dtype
    beta = 1.0 / temperature
    idx = torch.arange(M, device=E.device)
    is_left = (idx % 2 == parity) & (idx + 1 < M)
    log_alpha = (beta - torch.roll(beta, -1)) * (E - torch.roll(E, -1))
    if u is None:
        u = torch.clamp_min(torch.rand(M, generator=generator, dtype=dt, device=E.device), torch.finfo(dt).tiny)
    accept = is_left & (torch.log(u) < log_alpha)
    accept_right = torch.roll(accept, 1)  # entry k: swaps with k - 1
    perm = torch.where(accept, idx + 1, torch.where(accept_right, idx - 1, idx))
    return perm, is_left, accept


def replica_exchange(mc, parity: int, u=None, generator=None):
    """One replica-exchange pass over a batched sampler state (MCState or
    CBState) with M chains, or over the list of a chain-sharded run's shard
    states in chain order (each with its ChainBlock). `u` [M] gives the
    acceptance uniforms; otherwise they are drawn from `generator`. Returns
    (mc, attempted [M] bool, accepted [M] bool), where entry k refers to the
    pair (k, k+1); for shards, the list of new shard states, and the flags
    on the first shard's device.

    Shards: the energies and temperatures [M] are gathered on the first
    shard's device, where u is drawn and the global permutation computed,
    as in the unsharded pass; each shard then takes its new chains, and a
    pair that straddles a boundary moves one configuration between the two
    shards' devices."""
    if not isinstance(mc, (list, tuple)):
        st = mc.system
        perm, is_left, accept = _swap_perm(st.energy, st.temperature, parity, u, generator)
        return _permute([mc], lambda vs: vs[0][perm]), is_left, accept
    shards = list(mc)
    dev = shards[0].system.energy.device
    E = torch.cat([s.system.energy.to(dev) for s in shards])
    T = torch.cat([s.system.temperature.to(dev) for s in shards])
    perm, is_left, accept = _swap_perm(E, T, parity, u, generator)
    src = perm.tolist()
    bounds = [(s.chains.lo, s.chains.hi) for s in shards]
    out = []
    for p, (lo, hi) in enumerate(bounds):
        rows = src[lo:hi]
        if rows == list(range(lo, hi)):  # no configuration moves here
            out.append(shards[p])
            continue
        local = torch.tensor([min(max(r - lo, 0), hi - lo - 1) for r in rows], device=shards[p].system.energy.device)
        cross = [(i, q, r - bounds[q][0]) for i, r in enumerate(rows) if not lo <= r < hi
                 for q, (lo_q, hi_q) in enumerate(bounds) if lo_q <= r < hi_q]

        def take(vs, p=p, local=local, cross=cross):
            v = vs[p][local]
            for i, q, j in cross:
                v[i] = vs[q][j].to(v.device)
            return v

        out.append(_permute(shards, take, p))
    return out, is_left, accept


class ReplicaExchange:
    """Engine-facing wrapper: scheduled passes with acceptance counts. Its
    generator lives on the device of the first chains (the first shard's
    under chain sharding)."""

    def __init__(self, sim, seed: int = 0):
        self.sim = sim
        self.generator = torch.Generator(device=sim.device)
        self.generator.manual_seed(int(seed) ^ 0x5EED)
        self._parity = 0
        self.attempted = 0
        self.accepted = 0

    def step(self):
        sim = self.sim
        if sim.mesh is None:
            mc, att, acc = replica_exchange(sim.mc, self._parity, generator=self.generator)
            sim.mc = mc
        else:
            sim.shards, att, acc = replica_exchange(sim.shards, self._parity, generator=self.generator)
        self._parity ^= 1
        self.attempted += int(att.sum())
        self.accepted += int(acc.sum())

    @property
    def rate(self) -> float:
        return self.accepted / self.attempted if self.attempted else 0.0

"""The sequential Metropolis(-Hastings) kernel, batched over chains
(counterpart of particlesmc_tpu/moves/kernel.py).

One step makes one move per chain, as the reference's mc_step! does, and a
sweep is `sweepstep` steps (mc_sweep!):

- one generic proposal record covers every action: "particle i moves to
  pos_i, the species of (i, j) become (sp_i, sp_j)"; a displacement has
  j = i, a swap or a flip keeps pos_i;
- ΔE is the energy of the touched particles evaluated through the energy
  Override (core/energy.py), dense over all N particles or over cell-list
  candidates (core/neighbours.py), which the step keeps up to date;
- acceptance: log u < -(e2 - e1)/T + log q_rev - log q_fwd, a NaN
  log-acceptance rejects, and an infinite e1 or e2 books no energy.

Batched: every chain draws its own move of the pool. Each proposal kind in
the pool (displacement, DoubleUniform swap, EnergyBias swap, MoleculeFlip)
is evaluated for the whole batch with the parameters of each chain's chosen
move, and each chain keeps the proposal of its own move. A step is so a
fixed sequence of launches whatever the chains chose, with no host
synchronisation. Only the chosen move's proposal decides a chain's step; the
JAX package evaluates every proposal of the pool at every step, which
matters only for the MoleculeFlip loop (below).

The randomness of a sweep can be fed in (`draws`, the values after their
transformation, per chain and step), so that a test can give this port and
the JAX package the same numbers:

- move [B, S]: the pool index of each step's move;
- i [B, S] and normal [B, S, d]: the displacement's particle and its
  unscaled Gaussian step;
- r1, r2 [B, S]: a DoubleUniform swap's ranks within its two species
  populations;
- gumbel [B, S, 2, N]: the Gumbel noise of an EnergyBias swap's two
  categorical picks (i = argmax(logits + noise));
- flip [B, S, R, 3]: R rounds of MoleculeFlip candidates (m, a, b) per step,
  molecule m, site a and b in [0, max(L - 1, 1)) before it skips a;
- u [B, S]: the acceptance uniform.

Otherwise they come from the state's `torch.Generator`: one sweep's small
draws in a few launches at its start, then the Gumbel noise, for the whole
sweep where [B, S, 2, N] fits in _GUMBEL_BYTES, else in pieces of as many
steps as fit (`gumbel_steps`), each drawn as its piece begins. A chain shard
(`MCState.chains`) makes every draw at the global batch's shape and keeps its
rows, so that it draws what the unsharded run draws for its chains; fed-in
draws are given at that shape too.

On the card, a sweep whose pool is Gaussian displacements, DoubleUniform swaps
and EnergyBias swaps with the dense ΔE on an atomic system
(`takes_sweep_kernel`) runs its steps as one launch of the hand kernel
moves/seq_cuda.py (one per piece of Gumbel noise past the budget), on the
same draws and with the same arithmetic; it keeps each chain's per-particle
energies on chip for EnergyBias, so that no step costs more than O(N). Every
other sweep, and every sweep on the CPU, takes the step below, a few dozen
launches per step (~656 with both swaps); there EnergyBias computes the dense
per-particle energies twice per step, and every proposal kind of the pool is
evaluated for every chain and merged by move with torch.where.

MoleculeFlip resamples (m, a, b) until the two sites' species differ. The
port draws R rounds per step and takes each chain's first valid one; R is
chosen at `init_mc_state` from the molecules' species (which flips only
permute) so that a step finds none with probability below 1e-12, however
large that makes R. A sweep draws its rounds at its start while they number
at most _FLIP_SWEEP_DRAWS candidates, and per step past that. A chain
whose chosen flip finds none rejects it and sets its sticky `flip_failed`
flag, which the engine raises on: the port never returns an approximate
pick. On a system whose molecules each carry a single species the JAX
package's loop never ends; `init_mc_state` raises instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..core import neighbours as NB
from ..core.energy import (
    Override, particle_energy, particle_energy_nogather, per_particle_energies, per_particle_energies_of, take,
)
from ..core.state import ChainBlock, SystemState, draw_batch, own_rows, shared_box
from ..models.tables import PairTable, kinds_present
from . import seq_cuda
from .base import Move

# The engine's rule: below this particle count the sequential kernel runs
# the dense ΔE unless list_parameters.force_cells asks for the cell list
# (the JAX package's threshold, kept so that both packages pick the same
# mode for the same input).
DENSE_DELTA_MAX = 32768

# a step's chance of finding no valid MoleculeFlip pair in its R rounds,
# and the most candidates (chains x steps x R) a sweep draws at its start
_FLIP_MISS = 1e-12
_FLIP_SWEEP_DRAWS = 1 << 22

# the most bytes of EnergyBias Gumbel noise a sweep draws at once (256 MiB,
# 0.3% of an H100's memory): [28, 1000, 2, 1000] float32 is 224 MB, one draw
_GUMBEL_BYTES = 1 << 28

# the moves the hand kernel of the sequential sweep takes: (action, policy)
_KERNEL_MOVES = frozenset(seq_cuda.MOVE_KINDS)


class Proposal(NamedTuple):
    """One proposal per chain, [B] (pos_i [B, d])."""

    i: torch.Tensor  # particle whose position and species may change
    j: torch.Tensor  # second particle (species only); == i for a displacement
    pos_i: torch.Tensor
    sp_i: torch.Tensor
    sp_j: torch.Tensor
    log_q_fwd: torch.Tensor
    log_q_rev: torch.Tensor


class Action(NamedTuple):
    """A proposal as the policy-gradient estimator evaluates it
    (engine/pgmc.py): the step's record without its log q, plus the
    displacement δ (zeros for a swap or a flip), which the reward and the
    log-q functions read. Fields [B, *S], pos_i and delta [B, *S, d]. The
    step's Proposal carries no δ: each field there costs a torch.where per
    step."""

    i: torch.Tensor
    j: torch.Tensor
    pos_i: torch.Tensor
    sp_i: torch.Tensor
    sp_j: torch.Tensor
    delta: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MCState:
    """Sampler state of B chains under the sequential kernel. `generator`
    supplies every random draw; sweeps advance it in place. `chains` is a
    chain shard's place in the global batch (None unsharded)."""

    system: SystemState
    generator: torch.Generator
    cell: Optional[NB.CellList]  # None in dense mode
    attempted: torch.Tensor  # [B, n_moves] int64
    accepted: torch.Tensor  # [B, n_moves] int64
    flip_failed: torch.Tensor  # [B] bool, sticky: a chosen flip found no valid pair
    flip_rounds: int = 0  # MoleculeFlip candidate rounds per step (0: no flip)
    chains: Optional[ChainBlock] = None

    def replace(self, **kw) -> "MCState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static ingredients of the kernel."""

    pool: Tuple[Move, ...]
    table: PairTable
    cell_spec: Optional[NB.CellSpec]  # None: dense ΔE over all N
    mol_start: Optional[tuple] = None  # molecule layout, shared by the chains
    mol_len: Optional[tuple] = None
    sweepstep: Optional[int] = None  # steps per sweep; default N


def takes_sweep_kernel(config: KernelConfig, system: SystemState) -> bool:
    """Whether a sweep of `system` runs through the hand kernel
    (moves/seq_cuda.py): CUDA tensors, every move of the pool a Gaussian
    displacement, a DoubleUniform swap or an EnergyBias swap, the dense ΔE,
    an atomic system (no bonds, no molecule layout), d 2 or 3, and float32,
    mixed (float32 with a float64 ledger) or float64. Every other sweep
    (SmartGaussian, MoleculeFlip, the cell list, bonds) takes the plain step."""
    pos = system.position
    return (
        pos.device.type == "cuda" and config.cell_spec is None and config.mol_start is None
        and system.bonds is None and system.dim in (2, 3)
        and pos.dtype in (torch.float32, torch.float64) and system.energy.dtype in (pos.dtype, torch.float64)
        and all((mv.action, mv.policy) in _KERNEL_MOVES for mv in config.pool)
    )


def gumbel_steps(chains: int, steps: int, n: int, itemsize: int) -> int:
    """Steps per draw of a sweep's EnergyBias Gumbel noise [chains, steps, 2,
    n] of `itemsize`-byte floats: the whole sweep where it fits in
    _GUMBEL_BYTES, else as many steps as fit, at least one. On the card each
    draw is one launch of the hand kernel."""
    return max(1, min(int(steps), _GUMBEL_BYTES // (chains * 2 * n * itemsize)))


def flip_rounds(species, mol_start, mol_len) -> int:
    """Rounds R per step such that a chain misses a valid MoleculeFlip pair
    with probability <= _FLIP_MISS. One round fails with probability p, the
    share of (m, a, b) draws whose sites share a species (m uniform, a
    uniform in the molecule, b uniform among its other sites); flips only
    permute species within a molecule, so p is fixed by the start state.
    species [B, N] on any device (read once on the host). Raises when every
    draw fails: then no molecule has two sites of different species."""
    sp = np.asarray(species.cpu() if isinstance(species, torch.Tensor) else species)
    p = 0.0
    for row in sp.reshape(-1, sp.shape[-1]):
        fail = []
        for s0, L in zip(mol_start, mol_len):
            if L < 2:
                fail.append(1.0)
                continue
            site = row[s0:s0 + L]
            same = int(np.sum(site[:, None] == site[None, :])) - L
            fail.append(same / (L * (L - 1)))
        p = max(p, float(np.mean(fail)))
    if p >= 1.0:
        raise ValueError(
            "MoleculeFlip needs a molecule with two sites of different "
            "species; every molecule's sites share one species"
        )
    if p <= 0.0:
        return 1
    return max(1, math.ceil(math.log(_FLIP_MISS) / math.log(p)))


def init_mc_state(system: SystemState, config: KernelConfig, seed) -> MCState:
    """Initial sampler state (with the cell list built when the config has a
    grid); `seed` is an int or a torch.Generator on the state's device."""
    dev = system.position.device
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    cell = None
    if config.cell_spec is not None:
        if not shared_box(system.box):
            raise ValueError("the cell list needs all chains to share one box")
        cell = NB.build_cell_list(system.position, system.box, config.cell_spec)
    B = system.n_chains
    rounds = 0
    if any(mv.action == "flip" for mv in config.pool):
        if config.mol_start is None:
            raise ValueError("MoleculeFlip requires a molecular system")
        rounds = flip_rounds(system.species, config.mol_start, config.mol_len)
    zeros = torch.zeros((B, len(config.pool)), dtype=torch.int64, device=dev)
    return MCState(
        system=system, generator=gen, cell=cell, attempted=zeros, accepted=zeros.clone(),
        flip_failed=torch.zeros(B, dtype=torch.bool, device=dev), flip_rounds=rounds,
    )


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _at(x, k):
    """x[b, k[b]] for x [B, N, ...] and ids k [B]."""
    return take(x, k[:, None])[:, 0]


def _index(u, size):
    """floor(u * size), kept below size (an int or a tensor)."""
    k = torch.floor(u * size).long()
    return torch.minimum(k, size - 1) if isinstance(size, torch.Tensor) else torch.clamp_max(k, size - 1)


def _nth_member(species, s, r):
    """Id [B] of the r-th (0-based) particle of species s in each chain
    (species [B, N], s and r [B]); N for an empty population."""
    csum = torch.cumsum((species == s[:, None]).long(), dim=-1)
    return torch.searchsorted(csum, (r + 1)[:, None], side="left")[:, 0]


def _masked_logsumexp(vals, mask):
    """logsumexp over the lanes of `mask` (last axis) -> [...]."""
    v = torch.where(mask, vals, -math.inf)
    m = torch.amax(v, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.where(mask, torch.exp(v - m), 0.0)
    return m[..., 0] + torch.log(torch.sum(w, dim=-1))


def _by_move(move, moves, values):
    """Each chain's value [B] of a per-move parameter: values[k] belongs to
    pool move moves[k]; a chain whose move is not among them gets
    values[0] (its proposal is not kept)."""
    out = values[0]
    out = out.expand(move.shape) if isinstance(out, torch.Tensor) else torch.full_like(move, out)
    for m, v in zip(moves[1:], values[1:]):
        out = torch.where(move == m, v, out)
    return out


def _in_moves(move, moves):
    mask = move == moves[0]
    for m in moves[1:]:
        mask = mask | (move == m)
    return mask


class _Ctx:
    """What a step's proposals read: the live configuration and the static
    inputs."""

    def __init__(self, kernel, w, pool_params, counts):
        self.k = kernel
        self.w = w
        self.params = pool_params
        self.counts = counts  # [B, S_species], fixed over a sweep

    @property
    def position(self):
        return self.w.position

    @property
    def species(self):
        return self.w.species


# ---------------------------------------------------------------------------
# Proposals, one function per kind: (ctx, move [B], step draws) -> Proposal
# for the whole batch, with each chain's chosen move's parameters
# ---------------------------------------------------------------------------


def _propose_displacement(ctx, moves, move, dr):
    """Uniform particle + isotropic Gaussian step; log q of the symmetric
    Gaussian (kept exact for policy gradients)."""
    pos, sp = ctx.position, ctx.species
    d = pos.shape[-1]
    sigma = _by_move(move, moves, [ctx.params[m]["sigma"] for m in moves])[:, None]
    i = dr["i"]
    delta = sigma * dr["normal"]

    # log q(-δ) = log q(δ) exactly: one evaluation serves both directions
    s2 = sigma[:, 0] ** 2
    logq = -torch.sum(delta * delta, dim=-1) / (2 * s2) - d * torch.log(2.0 * math.pi * s2) / 2
    sp_i = _at(sp, i)
    return Proposal(
        i=i, j=i, pos_i=_at(pos, i) + delta, sp_i=sp_i, sp_j=sp_i,
        log_q_fwd=logq, log_q_rev=logq,
    )


def _swap_record(pos, sp, i, j, log_q_fwd, log_q_rev):
    """The species exchange of (i, j): i keeps its position."""
    n = sp.shape[-1]
    i, j = torch.clamp_max(i, n - 1), torch.clamp_max(j, n - 1)
    return Proposal(
        i=i, j=j, pos_i=_at(pos, i), sp_i=_at(sp, j), sp_j=_at(sp, i),
        log_q_fwd=log_q_fwd, log_q_rev=log_q_rev,
    )


def _propose_swap_uniform(ctx, moves, move, dr):
    """DiscreteSwap + DoubleUniform: one particle uniform from each species
    population. A swap on an empty population is rejected
    (log q_rev = -inf), never made on a clamped id."""
    pool = ctx.k.config.pool
    s1 = _by_move(move, moves, [pool[m].species[0] for m in moves])
    s2 = _by_move(move, moves, [pool[m].species[1] for m in moves])
    n1 = torch.gather(ctx.counts, 1, s1[:, None])[:, 0]
    n2 = torch.gather(ctx.counts, 1, s2[:, None])[:, 0]
    i = _nth_member(ctx.species, s1, dr["r1"])
    j = _nth_member(ctx.species, s2, dr["r2"])
    logq = -torch.log(torch.clamp_min(n1 * n2, 1).to(ctx.position.dtype))
    valid = (n1 > 0) & (n2 > 0)
    return _swap_record(
        ctx.position, ctx.species, i, j, logq, torch.where(valid, logq, -math.inf)
    )


def _propose_swap_energy_bias(ctx, moves, move, dr):
    """DiscreteSwap + EnergyBias: i drawn from species s1 with probability
    ∝ exp(θ1 E_i), j from s2 ∝ exp(θ2 E_j), E the per-particle energies
    (categorical = argmax of logits + Gumbel noise); the reverse density is
    evaluated in the post-swap configuration. An empty population rejects."""
    pool = ctx.k.config.pool
    pos, sp = ctx.position, ctx.species
    s1 = _by_move(move, moves, [pool[m].species[0] for m in moves])
    s2 = _by_move(move, moves, [pool[m].species[1] for m in moves])
    th1 = _by_move(move, moves, [ctx.params[m]["theta1"] for m in moves])[:, None]
    th2 = _by_move(move, moves, [ctx.params[m]["theta2"] for m in moves])[:, None]
    e_all = ctx.k.energies(pos, sp, ctx.w)
    m1, m2 = sp == s1[:, None], sp == s2[:, None]
    g = dr["gumbel"]
    i = torch.argmax(torch.where(m1, th1 * e_all, -math.inf) + g[:, 0], dim=-1)
    j = torch.argmax(torch.where(m2, th2 * e_all, -math.inf) + g[:, 1], dim=-1)

    lse1 = _masked_logsumexp(th1 * e_all, m1)
    lse2 = _masked_logsumexp(th2 * e_all, m2)
    log_q_fwd = th1[:, 0] * _at(e_all, i) + th2[:, 0] * _at(e_all, j) - lse1 - lse2
    sp2 = sp.scatter(1, i[:, None], _at(sp, j)[:, None]).scatter_(1, j[:, None], _at(sp, i)[:, None])
    e2_all = ctx.k.energies(pos, sp2, ctx.w)
    lse1b = _masked_logsumexp(th1 * e2_all, sp2 == s1[:, None])
    lse2b = _masked_logsumexp(th2 * e2_all, sp2 == s2[:, None])
    log_q_rev = th1[:, 0] * _at(e2_all, j) + th2[:, 0] * _at(e2_all, i) - lse1b - lse2b
    valid = m1.any(dim=-1) & m2.any(dim=-1)
    log_q_fwd = torch.where(valid, log_q_fwd, 0.0)
    log_q_rev = torch.where(valid, log_q_rev, -math.inf)
    return _swap_record(pos, sp, i, j, log_q_fwd, log_q_rev)


def _propose_flip(ctx, moves, move, dr):
    """MoleculeFlip + DoubleUniform: molecule m uniform, two distinct sites
    a != b uniform, species exchanged; the first of the step's R candidate
    rounds whose species differ. A chain with no valid round rejects, and
    if it chose the flip, sets its flip_failed flag."""
    pos, sp = ctx.position, ctx.species
    n = sp.shape[-1]
    ms, ml = ctx.k.mol_layout(pos.device)
    m, a, b = dr["flip"].unbind(-1)  # [B, R]
    b = b + (b >= a).long()
    start = ms[m]
    i = torch.clamp(start + a, 0, n - 1)
    j = torch.clamp(start + b, 0, n - 1)
    valid = take(sp, i) != take(sp, j)
    first = torch.argmax(valid.to(torch.uint8), dim=-1, keepdim=True)
    found = valid.any(dim=-1)
    i = torch.gather(i, 1, first)[:, 0]
    j = torch.gather(j, 1, first)[:, 0]
    ctx.w.flip_failed.logical_or_(_in_moves(move, moves) & ~found)
    logq = torch.full(found.shape, -math.log(2.0), dtype=pos.dtype, device=pos.device)
    return _swap_record(pos, sp, i, j, logq, torch.where(found, logq, -math.inf))


def make_proposal_fns(config: KernelConfig, n: int):
    """The pool's proposal kinds, in pool order of first appearance:
    [(propose, move indices)]. SmartGaussian runs on the checkerboard
    backend only, and MoleculeFlip needs a molecular system."""
    kinds = {}
    for m, mv in enumerate(config.pool):
        if mv.action == "displacement":
            if mv.policy == "smart":
                raise ValueError(
                    "SmartGaussian (force-bias) displacement runs on the "
                    "checkerboard backend only — set parallel_moves=true"
                )
            fn = _propose_displacement
        elif mv.action == "swap" and mv.policy == "double_uniform":
            fn = _propose_swap_uniform
        elif mv.action == "swap" and mv.policy == "energy_bias":
            fn = _propose_swap_energy_bias
        elif mv.action == "flip":
            if config.mol_start is None:
                raise ValueError("MoleculeFlip requires a molecular system")
            fn = _propose_flip
        else:  # pragma: no cover
            raise ValueError(f"unsupported move {mv}")
        kinds.setdefault(fn, []).append(m)
    return list(kinds.items())


# ---------------------------------------------------------------------------
# ΔE, log q and reward as functions of a proposal: the step reads the ΔE,
# the policy-gradient estimator all three
# ---------------------------------------------------------------------------


def _delta_e(config: KernelConfig, kinds, pos, sp, box, bonds, cell, prop, x_i=None):
    """(e1, e2) [B, *S]: the energies of i and j before and after proposals
    with fields [B, *S], each of j's terms only when j != i. The four
    evaluations (i old, j old, i new, j new) are rows of one energy call, a
    row per proposal and evaluation. `x_i` (i's position) is read from `pos`
    unless given."""
    i, j = prop.i, prop.j
    B = i.shape[0]
    mi = torch.full_like(i, -1)
    z = torch.zeros_like(i)
    zx = torch.zeros_like(prop.pos_i)

    def rows(*ts):
        """[B, *S, *t] each -> [B, len(ts) * S, *t], evaluation-major."""
        s = torch.stack(ts, dim=1)
        return s.reshape((B, -1) + s.shape[1 + i.dim():])

    ks = rows(i, j, i, j)
    ov = Override(
        i=rows(mi, mi, i, i), j=rows(mi, mi, j, j), pos_i=rows(zx, zx, prop.pos_i, prop.pos_i),
        sp_i=rows(z, z, prop.sp_i, prop.sp_i), sp_j=rows(z, z, prop.sp_j, prop.sp_j),
    )
    table = config.table
    if config.cell_spec is None:
        e4 = particle_energy_nogather(ks, pos, sp, box, table, bonds, ov, kinds)
    else:
        if x_i is None:
            x_i = take(pos, i)
        q = rows(x_i, take(pos, j), prop.pos_i)
        c = NB.candidates_around(q, box, cell, config.cell_spec)  # [B, 3 * S, M]
        c = c.reshape((B, 3, -1, c.shape[-1]))
        cands = torch.cat([c, c[:, 1:2]], dim=1)  # rows: i old, j, i new, j
        e4 = particle_energy(ks, cands.reshape((B, -1, c.shape[-1])), pos, sp, box, table, bonds, ov, kinds)
    e4 = e4.reshape((B, 4) + i.shape[1:])
    pair = (j != i).to(e4.dtype)
    return e4[:, 0] + pair * e4[:, 1], e4[:, 2] + pair * e4[:, 3]


def build_delta_e_fn(config: KernelConfig, n: int) -> Callable:
    """delta_e(system, cell, prop) -> (e1, e2) [B, *S]: the energies of the
    touched particles before and after proposals `prop` (a Proposal or an
    Action with fields [B, *S]) on `system`, dense over all N particles or,
    when the config has a grid, over the candidates of the cell list
    `cell`."""
    kinds = kinds_present(config.table)  # once: reads the table on the host

    def delta_e(system: SystemState, cell, prop):
        return _delta_e(config, kinds, system.position, system.species, system.box, system.bonds, cell, prop)

    return delta_e


def chain_energies(config, kinds, system, cell, species=None):
    """Per-particle energies of the chains [B, N], or of Q species
    assignments per chain [B, Q, N] when `species` [B, Q, N] is given:
    dense, or over each particle's cell candidates."""
    n = system.n_particles
    cand_fn = None
    if config.cell_spec is not None:
        def cand_fn(k):
            return NB.candidates_around(take(system.position, k), system.box, cell, config.cell_spec)
    if species is None:
        return per_particle_energies(
            system.position, system.species, system.box, config.table, system.bonds, chunk=n,
            cand_fn=cand_fn, kinds=kinds,
        )
    return per_particle_energies_of(
        system.position, species, system.box, config.table, system.bonds, cand_fn=cand_fn, kinds=kinds,
    )


def energy_bias_logq(config, kinds, system, cell, params, s1, s2, i, j):
    """(log q_fwd, log q_rev) [B, *S] of picking the pairs (i, j) [B, *S]
    under EnergyBias with theta1 and theta2 (tensors broadcast against i):
    i from species s1 with probability ∝ exp(theta1 E_i), j from s2 ∝
    exp(theta2 E_j). The reverse density is evaluated in the post-swap
    configuration of each pair."""
    th1, th2 = params["theta1"], params["theta2"]
    sp = system.species
    B, n = sp.shape
    shape = i.shape
    e_all = chain_energies(config, kinds, system, cell)
    i2, j2 = i.reshape(B, -1), j.reshape(B, -1)  # [B, Q]
    t1 = torch.as_tensor(th1).expand(shape).reshape(B, -1, 1)
    t2 = torch.as_tensor(th2).expand(shape).reshape(B, -1, 1)
    m1, m2 = (sp == s1)[:, None], (sp == s2)[:, None]
    ea = e_all[:, None]
    lse1 = _masked_logsumexp(t1 * ea, m1)
    lse2 = _masked_logsumexp(t2 * ea, m2)
    log_q_fwd = t1[..., 0] * take(e_all, i2) + t2[..., 0] * take(e_all, j2) - lse1 - lse2
    Q = i2.shape[1]
    sp2 = sp[:, None].expand(B, Q, n).clone()
    sp2.scatter_(2, i2[..., None], take(sp, j2)[..., None])
    sp2.scatter_(2, j2[..., None], take(sp, i2)[..., None])
    e2_all = chain_energies(config, kinds, system, cell, sp2)  # [B, Q, N]
    lse1b = _masked_logsumexp(t1 * e2_all, sp2 == s1)
    lse2b = _masked_logsumexp(t2 * e2_all, sp2 == s2)
    pick = lambda e, k: torch.gather(e, 2, k[..., None])[..., 0]  # noqa: E731
    log_q_rev = t1[..., 0] * pick(e2_all, j2) + t2[..., 0] * pick(e2_all, i2) - lse1b - lse2b
    return log_q_fwd.reshape(shape), log_q_rev.reshape(shape)


def make_logq_fns(config: KernelConfig, n: int):
    """Per pool move, `logq(prop, system, cell, params) -> (log q_fwd,
    log q_rev)` [B, *S] recomputed from a fixed Action: the differentiable
    path of the policy gradient through the move's parameters, which may be
    tensors broadcast against the action's [B, *S] (one copy per sample)."""
    kinds = kinds_present(config.table)
    fns = []
    for mv in config.pool:
        if mv.action == "displacement":

            def f(prop, system, cell, params):
                d = system.dim
                s2 = params["sigma"] ** 2
                norm2 = torch.sum(prop.delta * prop.delta, dim=-1)
                lq = -norm2 / (2 * s2) - d * torch.log(2.0 * math.pi * s2) / 2
                return lq, lq

        elif mv.action == "swap" and mv.policy == "double_uniform":

            def f(prop, system, cell, params, s1=mv.species[0], s2=mv.species[1]):
                sp = system.species
                n12 = torch.sum(sp == s1, dim=-1) * torch.sum(sp == s2, dim=-1)
                lq = -torch.log(n12.to(system.position.dtype))
                lq = lq.reshape((-1,) + (1,) * (prop.i.dim() - 1)).expand(prop.i.shape)
                return lq, lq

        elif mv.action == "swap" and mv.policy == "energy_bias":

            def f(prop, system, cell, params, s1=mv.species[0], s2=mv.species[1]):
                return energy_bias_logq(config, kinds, system, cell, params, s1, s2, prop.i, prop.j)

        elif mv.action == "flip":

            def f(prop, system, cell, params):
                lq = torch.full(prop.i.shape, -math.log(2.0), dtype=system.position.dtype,
                                device=prop.i.device)
                return lq, lq

        else:
            raise ValueError(f"no log q for move {mv}")
        fns.append(f)
    return fns


def move_reward(mv: Move) -> Callable:
    """The policy-gradient reward of an action, `reward(prop, system)`
    [B, *S]: |δ|² for a displacement, 1 for a swap or a flip."""
    if mv.action == "displacement":
        return lambda prop, system: torch.sum(prop.delta * prop.delta, dim=-1)
    return lambda prop, system: torch.ones(prop.i.shape, dtype=system.position.dtype, device=prop.i.device)


# ---------------------------------------------------------------------------
# The step and the sweep
# ---------------------------------------------------------------------------


class _Work:
    """A sweep's working copy of the mutable state, updated in place."""

    def __init__(self, mc: MCState):
        st = mc.system
        self.system = st
        self.position = st.position.clone()
        self.species = st.species.clone()
        self.energy = st.energy.clone()
        self.cell = None
        if mc.cell is not None:
            c = mc.cell
            self.cell = c.replace(
                bucket=c.bucket.clone(), count=c.count.clone(),
                cell_of=c.cell_of.clone(), overflow=c.overflow.clone(),
            )
        self.flip_failed = mc.flip_failed.clone()

    def state(self, mc: MCState, attempted, accepted) -> MCState:
        return mc.replace(
            system=self.system.replace(position=self.position, species=self.species, energy=self.energy),
            cell=self.cell, attempted=attempted, accepted=accepted, flip_failed=self.flip_failed,
        )


class _Kernel:
    """The step of one KernelConfig, with its device constants."""

    def __init__(self, config: KernelConfig, n: int):
        self.config = config
        self.n = n
        self.kinds = kinds_present(config.table)  # once: reads the table on the host
        self.proposals = make_proposal_fns(config, n)
        self.spec = config.cell_spec
        pool = config.pool
        self.has_disp = any(mv.action == "displacement" for mv in pool)
        self.has_uniform = any(mv.action == "swap" and mv.policy == "double_uniform" for mv in pool)
        self.has_bias = any(mv.action == "swap" and mv.policy == "energy_bias" for mv in pool)
        self.has_flip = any(mv.action == "flip" for mv in pool)
        self.has_swap = self.has_uniform or self.has_bias
        p = np.asarray([mv.probability for mv in pool], np.float64)
        self.cum = np.cumsum(p / p.sum())[:-1].tolist()  # move = #{cum_k <= u}
        self._mol = {}
        self._packed = {}  # per (device, dtype): the packed table and the move table

    def draw_keys(self):
        keys = {"move", "u"}
        if self.has_disp:
            keys |= {"i", "normal"}
        if self.has_uniform:
            keys |= {"r1", "r2"}
        if self.has_bias:
            keys.add("gumbel")
        if self.has_flip:
            keys.add("flip")
        return keys

    def mol_layout(self, device):
        """Molecule starts and lengths as device tensors (copied once)."""
        if device not in self._mol:
            c = self.config
            self._mol[device] = (
                torch.tensor(np.asarray(c.mol_start, np.int64), device=device),
                torch.tensor(np.asarray(c.mol_len, np.int64), device=device),
            )
        return self._mol[device]

    def energies(self, position, species, w):
        """Per-particle energies [B, N] (EnergyBias): dense, or over each
        particle's cell candidates."""
        return chain_energies(self.config, self.kinds, w.system.replace(position=position, species=species), w.cell)

    def move_index(self, u):
        """Each uniform's pool move, #{cum_k <= u} (cum the pool's cumulative
        shares)."""
        move = torch.zeros_like(u, dtype=torch.int64)
        for c in self.cum:
            move += (u >= c).long()
        return move

    def draw_sweep(self, mc: MCState, steps: int):
        """One sweep's draws from the state's generator (the Gumbel noise
        last, and only where the whole sweep's fits in _GUMBEL_BYTES: else
        `pieces` draws it)."""
        st = mc.system
        n, d = st.position.shape[1:]
        B = draw_batch(mc.chains, st.n_chains)  # the global batch's
        dev, dt = st.position.device, st.position.dtype
        gen = mc.generator

        def uniform(*shape, dtype=torch.float64):
            return own_rows(torch.rand(shape, generator=gen, dtype=dtype, device=dev), mc.chains)

        out = {"move": self.move_index(uniform(B, steps))}
        if self.has_disp:
            out["i"] = _index(uniform(B, steps), n)
            out["normal"] = own_rows(torch.randn((B, steps, d), generator=gen, dtype=dt, device=dev), mc.chains)
        if self.has_uniform:
            # ranks are uniforms here, scaled by the chosen swap's
            # population in the step
            out["r1"], out["r2"] = uniform(B, steps), uniform(B, steps)
        if self.has_flip and B * steps * mc.flip_rounds <= _FLIP_SWEEP_DRAWS:
            out["flip"] = self.flip_draws(mc, steps)
        out["u"] = torch.clamp_min(uniform(B, steps, dtype=dt), torch.finfo(dt).tiny)
        if self.has_bias and self.noise_steps(mc, steps) >= steps:
            out["gumbel"] = self.gumbel(mc, steps)
        return out

    def flip_draws(self, mc: MCState, steps: int):
        """MoleculeFlip candidate rounds (m, a, b) [B, steps, R, 3] from the
        state's generator."""
        dev = mc.system.position.device
        _, ml = self.mol_layout(dev)
        shape = (draw_batch(mc.chains, mc.system.n_chains), steps, mc.flip_rounds, 3)
        u = own_rows(torch.rand(shape, generator=mc.generator, dtype=torch.float64, device=dev), mc.chains)
        m = _index(u[..., 0], len(self.config.mol_start))
        L = ml[m]
        return torch.stack([m, _index(u[..., 1], L), _index(u[..., 2], torch.clamp_min(L - 1, 1))], dim=-1)

    def noise_steps(self, mc: MCState, steps: int) -> int:
        """Steps per draw of the sweep's Gumbel noise (gumbel_steps, at the
        global batch's shape, as the noise is drawn)."""
        st = mc.system
        return gumbel_steps(draw_batch(mc.chains, st.n_chains), steps, st.n_particles, st.position.element_size())

    def gumbel(self, mc: MCState, steps: int):
        """EnergyBias's Gumbel noise [B, steps, 2, N] from the state's
        generator, -log(-log u) of uniforms u kept at least the dtype's
        smallest normal (in place: a sweep's noise may take _GUMBEL_BYTES)."""
        st = mc.system
        B, n = draw_batch(mc.chains, st.n_chains), st.n_particles
        dt = st.position.dtype
        u = own_rows(torch.rand((B, steps, 2, n), generator=mc.generator, dtype=dt, device=st.position.device),
                     mc.chains)
        return u.clamp_min_(torch.finfo(dt).tiny).log_().neg_().log_().neg_()

    def pieces(self, mc: MCState, steps: int, draws):
        """The sweep's draws as the launches (and the plain step's loop)
        take them: whole, unless the pool has EnergyBias and its noise is
        not among them; then in pieces of noise_steps steps, each piece's
        noise drawn from the state's generator as the piece begins."""
        if not self.has_bias or "gumbel" in draws:
            yield draws
            return
        c = self.noise_steps(mc, steps)
        for s0 in range(0, steps, c):
            part = {key: v[:, s0:s0 + c] for key, v in draws.items()}
            part["gumbel"] = self.gumbel(mc, part["move"].shape[1])
            yield part

    def step(self, w: _Work, pool_params, dr, counts):
        """One step of every chain, in place on `w`; returns accept [B]."""
        with tracing.span("seq.step"):
            st = w.system
            pos, sp = w.position, w.species
            move = dr["move"]
            with tracing.span("seq.propose"):
                ctx = _Ctx(self, w, pool_params, counts)
                prop = None
                for fn, moves in self.proposals:
                    p = fn(ctx, moves, move, dr)
                    if prop is None:
                        prop = p
                    else:
                        mask = _in_moves(move, moves)
                        prop = Proposal(*(
                            torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
                            for a, b in zip(p, prop)
                        ))
            i, j = prop.i, prop.j
            with tracing.span("seq.delta_e"):
                x_i = _at(pos, i)
                e1, e2 = self.delta_e(w, prop, x_i)

            with tracing.span("seq.accept"):
                # Metropolis-Hastings
                log_alpha = -(e2 - e1) / st.temperature + prop.log_q_rev - prop.log_q_fwd
                log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
                accept = torch.log(dr["u"]) < log_alpha

                # the ledger, with the Inf guard; f32 ΔE widens into an f64 ledger
                de = torch.where(torch.isinf(e1) | torch.isinf(e2), 0.0, e2 - e1)
                w.energy += torch.where(accept, de, 0.0)

                new_pos_i = torch.where(accept[:, None], prop.pos_i, x_i)
                new_sp_i = torch.where(accept, prop.sp_i, _at(sp, i))
                new_sp_j = torch.where(accept, prop.sp_j, _at(sp, j))
                pos.scatter_(1, i[:, None, None].expand(-1, 1, pos.shape[-1]), new_pos_i[:, None])
                sp.scatter_(1, i[:, None], new_sp_i[:, None])
                sp.scatter_(1, j[:, None], new_sp_j[:, None])
            if self.spec is not None:
                with tracing.span("seq.cell_update"):
                    NB.move_particle_(w.cell, i, NB.cell_index(new_pos_i, st.box, self.spec))
            return accept

    def device_tables(self, device, dt):
        """The packed pair table and the move table (seq_cuda.move_table) on
        `device`, built once per device and dtype."""
        key = (device, dt)
        if key not in self._packed:
            self._packed[key] = (
                seq_cuda.pack_table(self.config.table, dt).to(device),
                torch.tensor(seq_cuda.move_table(self.config.pool), dtype=torch.int32, device=device),
            )
        return self._packed[key]

    def sweep_kernel(self, st: SystemState, pool_params, draws):
        """The steps of `draws` for every chain as one launch of the hand
        kernel (takes_sweep_kernel): (the system after them, accepts [B,
        steps]). Sigma per move, and EnergyBias's theta1 and theta2, are read
        from `pool_params` on the device, detached, per chain where they are
        [B] tensors (1 and 0 where a move has none)."""
        pos = st.position
        dt, dev, B = pos.dtype, pos.device, st.n_chains
        table, moves = self.device_tables(dev, dt)

        def per_chain(name, empty):
            return torch.stack([(p[name].detach().to(dt) if name in p else empty).expand(B) for p in pool_params], dim=1)

        def get(name, dtype=None):
            return draws[name].to(dtype or draws[name].dtype).contiguous() if name in draws else None

        with tracing.span("seq.sweep_kernel"):
            sigma = per_chain("sigma", torch.ones((), dtype=dt, device=dev) if self.has_swap else None)
            theta = None
            if self.has_bias:
                nil = torch.zeros((), dtype=dt, device=dev)
                theta = torch.stack([per_chain("theta1", nil), per_chain("theta2", nil)], dim=-1)
            position, species, energy, accepts = seq_cuda.sweep(
                pos, st.species, st.box, st.temperature, st.energy, table, sigma, get("move"), get("i"),
                get("normal", dt), get("u", dt), moves=moves if self.has_swap else None, theta=theta, r1=get("r1"),
                r2=get("r2"), gumbel=get("gumbel", dt), kinds=self.kinds,
            )
        return st.replace(position=position, species=species, energy=energy), accepts

    def delta_e(self, w: _Work, prop: Proposal, x_i):
        """(e1, e2) [B] of the step's proposals on the working state."""
        st = w.system
        return _delta_e(self.config, self.kinds, w.position, w.species, st.box, st.bonds, w.cell, prop, x_i)

    def prepare(self, mc: MCState, steps: int, draws):
        """The sweep's draws (checked when fed in) and species counts."""
        with tracing.span("seq.draws"):
            if draws is None:
                draws = self.draw_sweep(mc, steps)
            else:
                need = self.draw_keys()
                if set(draws) != need:
                    raise ValueError(f"this pool takes draws {sorted(need)}, got {sorted(draws)}")
                if any(v.shape[1] != steps for v in draws.values()):
                    raise ValueError(f"draws must cover the sweep's {steps} steps")
                draws = {k: own_rows(v, mc.chains) for k, v in draws.items()}
            counts = None
            if self.has_uniform:
                sp = mc.system.species
                counts = torch.zeros((sp.shape[0], self.config.table.n_species), dtype=torch.int64, device=sp.device)
                counts.scatter_add_(1, sp, torch.ones_like(sp))
                if "r1" in draws and draws["r1"].is_floating_point():
                    draws = self._scale_ranks(draws, counts)
        return draws, counts

    def _scale_ranks(self, draws, counts):
        """Generated rank uniforms -> ranks in the chosen swap's populations
        (populations are fixed: every move keeps each chain's
        composition)."""
        pool = self.config.pool
        moves = [m for m, mv in enumerate(pool) if mv.action == "swap" and mv.policy == "double_uniform"]
        move = draws["move"]
        out = dict(draws)
        for key, side in (("r1", 0), ("r2", 1)):
            s = _by_move(move, moves, [pool[m].species[side] for m in moves])
            size = torch.clamp_min(torch.gather(counts, 1, s), 1)
            out[key] = torch.minimum(torch.floor(draws[key] * size).long(), size - 1)
        return out


def build_step_fn(config: KernelConfig, n: int) -> Callable:
    """Returns `step(mc, pool_params, draws) -> (mc, accept [B])`: one step
    of every chain on the step's draws (the sweep's fields at one step:
    move [B], u [B], ..., gumbel [B, 2, N], flip [B, R, 3])."""
    k = _Kernel(config, n)

    def step(mc: MCState, pool_params, draws):
        w = _Work(mc)
        one = {key: v[:, None] for key, v in draws.items()}
        one, counts = k.prepare(mc, 1, one)
        accept = k.step(w, pool_params, {key: v[:, 0] for key, v in one.items()}, counts)
        move = one["move"][:, 0]
        att = mc.attempted.scatter_add(1, move[:, None], torch.ones_like(move)[:, None])
        acc = mc.accepted.scatter_add(1, move[:, None], accept.long()[:, None])
        return w.state(mc, att, acc), accept

    return step


def build_sweep_fn(config: KernelConfig, n: int) -> Callable:
    """Returns `sweep(mc, pool_params, draws=None) -> MCState`: `sweepstep`
    (default n) steps of every chain. `draws` feeds in the sweep's
    randomness (module docstring); the state's generator supplies it
    otherwise. `sweep.plain` has the same signature and runs the sweep
    through the plain step whatever the input: the reference that the hand
    kernel is held to on the card."""
    k = _Kernel(config, n)
    steps = int(config.sweepstep or n)

    def counted(mc, move, accepts):
        """(attempted, accepted) after the sweep's moves and accepts."""
        return mc.attempted.scatter_add(1, move, torch.ones_like(move)), mc.accepted.scatter_add(1, move, accepts)

    def sweep(mc: MCState, pool_params, draws=None) -> MCState:
        if not takes_sweep_kernel(config, mc.system):
            return plain(mc, pool_params, draws)
        draws, _ = k.prepare(mc, steps, draws)
        st, accepts = mc.system, []
        for part in k.pieces(mc, steps, draws):
            st, acc = k.sweep_kernel(st, pool_params, part)
            accepts.append(acc)
        att, acc = counted(mc, draws["move"], accepts[0] if len(accepts) == 1 else torch.cat(accepts, dim=1))
        return mc.replace(system=st, attempted=att, accepted=acc)

    def plain(mc: MCState, pool_params, draws=None) -> MCState:
        draws, counts = k.prepare(mc, steps, draws)
        w = _Work(mc)
        B = mc.system.n_chains
        accepts = torch.zeros((B, steps), dtype=torch.int64, device=mc.system.position.device)
        s = 0
        for part in k.pieces(mc, steps, draws):
            for t in range(part["move"].shape[1]):
                dr = {key: v[:, t] for key, v in part.items()}
                if k.has_flip and "flip" not in dr:
                    dr["flip"] = k.flip_draws(mc, 1)[:, 0]
                accepts[:, s] = k.step(w, pool_params, dr, counts)
                s += 1
        return w.state(mc, *counted(mc, draws["move"], accepts))

    sweep.plain = plain
    return sweep


def build_run_fn(config: KernelConfig, n: int) -> Callable:
    """Returns `run(mc, pool_params, n_sweeps) -> MCState`: `n_sweeps`
    sweeps, each on the state's generator, with no host synchronisation."""
    sweep = build_sweep_fn(config, n)

    def run(mc: MCState, pool_params, n_sweeps: int) -> MCState:
        for _ in range(int(n_sweeps)):
            mc = sweep(mc, pool_params)
        return mc

    return run


def check_state(mc: MCState):
    """Raise on a sticky device-side error: a cell-list bucket overflow, or
    a chosen MoleculeFlip that found no valid pair (reads the flags: a
    host synchronisation)."""
    if mc.cell is not None and bool(mc.cell.overflow.any()):
        raise RuntimeError("cell-list bucket overflow: increase list_parameters.cap")
    if bool(mc.flip_failed.any()):
        raise RuntimeError(
            f"MoleculeFlip found no pair of different species in its {mc.flip_rounds} "
            "candidate rounds on some step"
        )

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
draws in a few launches at its start, the Gumbel noise per step.

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

from ..core import neighbours as NB
from ..core.energy import Override, particle_energy, particle_energy_nogather, per_particle_energies, take
from ..core.state import SystemState
from ..models.tables import PairTable, kinds_present
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


class Proposal(NamedTuple):
    """One proposal per chain, [B] (pos_i [B, d])."""

    i: torch.Tensor  # particle whose position and species may change
    j: torch.Tensor  # second particle (species only); == i for a displacement
    pos_i: torch.Tensor
    sp_i: torch.Tensor
    sp_j: torch.Tensor
    log_q_fwd: torch.Tensor
    log_q_rev: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MCState:
    """Sampler state of B chains under the sequential kernel. `generator`
    supplies every random draw; sweeps advance it in place."""

    system: SystemState
    generator: torch.Generator
    cell: Optional[NB.CellList]  # None in dense mode
    attempted: torch.Tensor  # [B, n_moves] int64
    accepted: torch.Tensor  # [B, n_moves] int64
    flip_failed: torch.Tensor  # [B] bool, sticky: a chosen flip found no valid pair
    flip_rounds: int = 0  # MoleculeFlip candidate rounds per step (0: no flip)

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
        if not torch.equal(system.box, system.box[:1].expand_as(system.box)):
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
        p = np.asarray([mv.probability for mv in pool], np.float64)
        self.cum = np.cumsum(p / p.sum())[:-1].tolist()  # move = #{cum_k <= u}
        self._mol = {}

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
        st = w.system
        cand_fn = None
        if self.spec is not None:
            def cand_fn(k):
                return NB.candidates_around(take(position, k), st.box, w.cell, self.spec)
        return per_particle_energies(
            position, species, st.box, self.config.table, st.bonds, chunk=self.n, cand_fn=cand_fn,
            kinds=self.kinds,
        )

    def draw_sweep(self, mc: MCState, steps: int):
        """One sweep's draws from the state's generator (the Gumbel noise is
        drawn per step)."""
        st = mc.system
        B, n, d = st.position.shape
        dev, dt = st.position.device, st.position.dtype
        gen = mc.generator

        def uniform(*shape, dtype=torch.float64):
            return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

        u_move = uniform(B, steps)
        move = torch.zeros((B, steps), dtype=torch.int64, device=dev)
        for c in self.cum:
            move += (u_move >= c).long()
        out = {"move": move}
        if self.has_disp:
            out["i"] = _index(uniform(B, steps), n)
            out["normal"] = torch.randn((B, steps, d), generator=gen, dtype=dt, device=dev)
        if self.has_uniform:
            # ranks are uniforms here, scaled by the chosen swap's
            # population in the step
            out["r1"], out["r2"] = uniform(B, steps), uniform(B, steps)
        if self.has_flip and B * steps * mc.flip_rounds <= _FLIP_SWEEP_DRAWS:
            out["flip"] = self.flip_draws(mc, steps)
        out["u"] = torch.clamp_min(uniform(B, steps, dtype=dt), torch.finfo(dt).tiny)
        return out

    def flip_draws(self, mc: MCState, steps: int):
        """MoleculeFlip candidate rounds (m, a, b) [B, steps, R, 3] from the
        state's generator."""
        dev = mc.system.position.device
        _, ml = self.mol_layout(dev)
        shape = (mc.system.n_chains, steps, mc.flip_rounds, 3)
        u = torch.rand(shape, generator=mc.generator, dtype=torch.float64, device=dev)
        m = _index(u[..., 0], len(self.config.mol_start))
        L = ml[m]
        return torch.stack([m, _index(u[..., 1], L), _index(u[..., 2], torch.clamp_min(L - 1, 1))], dim=-1)

    def gumbel(self, mc: MCState):
        st = mc.system
        B, n, _ = st.position.shape
        dt = st.position.dtype
        u = torch.rand((B, 2, n), generator=mc.generator, dtype=dt, device=st.position.device)
        return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(dt).tiny)))

    def step(self, w: _Work, pool_params, dr, counts):
        """One step of every chain, in place on `w`; returns accept [B]."""
        st = w.system
        pos, sp = w.position, w.species
        move = dr["move"]
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
        x_i = _at(pos, i)
        e1, e2 = self.delta_e(w, prop, x_i)

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
            NB.move_particle_(w.cell, i, NB.cell_index(new_pos_i, st.box, self.spec))
        return accept

    def delta_e(self, w: _Work, prop: Proposal, x_i):
        """(e1, e2) [B]: the energies of i and j before and after the
        proposal, each of j's terms only when j != i."""
        st = w.system
        pos, sp = w.position, w.species
        i, j = prop.i, prop.j
        mi = torch.full_like(i, -1)
        z = torch.zeros_like(i)
        zx = torch.zeros_like(prop.pos_i)
        ks = torch.stack([i, j, i, j], dim=1)
        ov = Override(
            i=torch.stack([mi, mi, i, i], dim=1),
            j=torch.stack([mi, mi, j, j], dim=1),
            pos_i=torch.stack([zx, zx, prop.pos_i, prop.pos_i], dim=1),
            sp_i=torch.stack([z, z, prop.sp_i, prop.sp_i], dim=1),
            sp_j=torch.stack([z, z, prop.sp_j, prop.sp_j], dim=1),
        )
        table = self.config.table
        if self.spec is None:
            e4 = particle_energy_nogather(ks, pos, sp, st.box, table, st.bonds, ov, self.kinds)
        else:
            x_j = _at(pos, j)
            q = torch.stack([x_i, x_j, prop.pos_i], dim=1)
            c = NB.candidates_around(q, st.box, w.cell, self.spec)  # [B, 3, M]
            cands = torch.cat([c, c[:, 1:2]], dim=1)  # rows: i old, j, i new, j
            e4 = particle_energy(ks, cands, pos, sp, st.box, table, st.bonds, ov, self.kinds)
        pair = (j != i).to(e4.dtype)
        return e4[:, 0] + pair * e4[:, 1], e4[:, 2] + pair * e4[:, 3]

    def prepare(self, mc: MCState, steps: int, draws):
        """The sweep's draws (checked when fed in) and species counts."""
        if draws is None:
            draws = self.draw_sweep(mc, steps)
        else:
            need = self.draw_keys()
            if set(draws) != need:
                raise ValueError(f"this pool takes draws {sorted(need)}, got {sorted(draws)}")
            if any(v.shape[1] != steps for v in draws.values()):
                raise ValueError(f"draws must cover the sweep's {steps} steps")
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
    otherwise."""
    k = _Kernel(config, n)
    steps = int(config.sweepstep or n)

    def sweep(mc: MCState, pool_params, draws=None) -> MCState:
        draws, counts = k.prepare(mc, steps, draws)
        w = _Work(mc)
        B = mc.system.n_chains
        accepts = torch.zeros((B, steps), dtype=torch.int64, device=mc.system.position.device)
        for s in range(steps):
            dr = {key: v[:, s] for key, v in draws.items()}
            if k.has_bias and "gumbel" not in dr:
                dr["gumbel"] = k.gumbel(mc)
            if k.has_flip and "flip" not in dr:
                dr["flip"] = k.flip_draws(mc, 1)[:, 0]
            accepts[:, s] = k.step(w, pool_params, dr, counts)
        move = draws["move"]
        att = mc.attempted.scatter_add(1, move, torch.ones_like(move))
        acc = mc.accepted.scatter_add(1, move, accepts)
        return w.state(mc, att, acc)

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

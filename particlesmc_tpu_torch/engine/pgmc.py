"""Policy-guided Monte Carlo: online learning of proposal parameters
(counterpart of particlesmc_tpu/engine/pgmc.py).

The objective per move is the expected accepted reward

    J(θ) = E_{x~π, a~q_θ(·|x)} [ min(1, e^{Δlogπ + log q_rev − log q_fwd}) · R(a) ]

with R(a) = |δ|² for a displacement and 1 for a swap (moves/kernel.py
move_reward). The gradient is the score-function form with detached actions,

    ∇J ≈ mean_b [ (∇θ log q_fwd,b) · stopgrad(A_b R_b) + ∇θ(A_b R_b) ],

taken by autograd of the surrogate
L(θ) = exp(log q_fwd(a;θ) − stopgrad(log q_fwd(a;θ))) · A(a;θ) · R(a).

Optimisers:
- VPG(lr): vanilla policy gradient ascent θ += lr·g;
- BLANPG(lr, reg): natural policy gradient, g preconditioned by the inverse
  of the Fisher matrix F = E[∇log q ∇log qᵀ] + reg·I estimated on the same
  batch.

Batched: the JAX package takes the per-sample gradients under two vmaps
(chains × `q_batch_size`). Here each move's θ is a leaf expanded to
[M, Q], every (chain, sample) surrogate reads only its own copy, and one
autograd pass over the sum gives all M·Q per-sample gradients at once (a
second pass over log q_fwd gives the scores). The proposals are rows of one
ΔE call per move; an EnergyBias move evaluates its post-swap energies as
[M, Q, N] on each chain's positions, chunked. `estimate()` issues no host
synchronisation.

The estimator draws its proposals from a torch.Generator of its own on the
chains' device, seeded from the simulation's seed + 777 (as the JAX package
seeds its key); io/checkpoint.py does not store it.

Under chain sharding each shard evaluates its own chains with a copy of that
generator on its device, drawing the global batch's proposals and keeping
its rows (parallel/mesh.py). The per-chain estimates [M, P] and [M, P, P]
are gathered in chain order on the first shard's device and averaged there,
in the unsharded order of summation; they differ from the unsharded run's
only where a per-chain value does (a reduction that the device tiles
differently for another batch size), which the tests bound at 1e-12
relative in float64.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple

import numpy as np
import torch

from ..core.energy import take
from ..core.state import draw_batch, own_rows
from ..models.tables import kinds_present
from ..moves import kernel as K
from ..parallel import mesh as PM


@dataclasses.dataclass(frozen=True)
class VPG:
    lr: float


@dataclasses.dataclass(frozen=True)
class BLANPG:
    lr: float
    reg: float


def _sample_displacement(theta, gen, system, q, block=None):
    """q actions per chain: a uniform particle and δ = σ·ξ."""
    B, n, d = system.position.shape
    Bd = draw_batch(block, B)
    dev, dt = system.position.device, system.position.dtype
    u = own_rows(torch.rand((Bd, q), generator=gen, dtype=torch.float64, device=dev), block)
    i = torch.clamp_max(torch.floor(u * n).long(), n - 1)
    sigma = torch.as_tensor(theta["sigma"]).expand(B, q)
    delta = sigma[..., None] * own_rows(torch.randn((Bd, q, d), generator=gen, dtype=dt, device=dev), block)
    sp_i = take(system.species, i)
    return K.Action(i=i, j=i, pos_i=take(system.position, i) + delta, sp_i=sp_i, sp_j=sp_i, delta=delta)


def _sample_energy_bias(config, kinds, theta, gen, system, cell, q, s1, s2, block=None):
    """q pairs per chain: i from species s1 with probability ∝ exp(θ1 E_i),
    j from s2 ∝ exp(θ2 E_j) (argmax of the logits plus Gumbel noise)."""
    B, n, d = system.position.shape
    dev, dt = system.position.device, system.position.dtype
    e_all = K.chain_energies(config, kinds, system, cell)[:, None]  # [B, 1, N]
    sp = system.species
    u = own_rows(torch.rand((draw_batch(block, B), q, 2, n), generator=gen, dtype=dt, device=dev), block)
    g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(dt).tiny)))
    picks = []
    for k, (s, th) in enumerate(((s1, theta["theta1"]), (s2, theta["theta2"]))):
        th = torch.as_tensor(th).expand(B, q)[..., None]
        logits = torch.where((sp == s)[:, None], th * e_all, -math.inf)
        picks.append(torch.argmax(logits + g[:, :, k], dim=-1))
    i, j = picks
    pos = system.position
    return K.Action(
        i=i, j=j, pos_i=take(pos, i), sp_i=take(sp, j), sp_j=take(sp, i),
        delta=torch.zeros((B, q, d), dtype=dt, device=dev),
    )


def build_surrogate_fns(config: K.KernelConfig, n: int):
    """(sample_prop, surrogate_at) for the estimator.

    sample_prop(theta, m, generator, system, cell, q, block=None) draws q
    detached actions per chain from q_θ of move m (an Action with fields
    [M, q]); a chain shard (`block`) draws the global batch's and keeps its
    rows.
    surrogate_at(prop, theta, m, system, cell) evaluates, per action, the
    surrogate L(θ) = exp(log q(a;θ) − stopgrad(log q(a;θ))) · A(a;θ) · R(a)
    at the FIXED action and returns (L, log q_fwd), both [M, *S]; θ's
    tensors broadcast against the action's [M, *S]. Autograd of L at the
    sampling θ is the score-function term plus the pathwise acceptance
    term. e1, e2 and R are detached, and a NaN log-acceptance rejects."""
    delta_e = K.build_delta_e_fn(config, n)
    logq_fns = K.make_logq_fns(config, n)
    rewards = [K.move_reward(mv) for mv in config.pool]
    kinds = kinds_present(config.table)

    def sample_prop(theta, m, generator, system, cell, q, block=None):
        mv = config.pool[m]
        with torch.no_grad():
            if mv.action == "displacement" and mv.policy == "gaussian":
                return _sample_displacement(theta, generator, system, q, block)
            if mv.action == "swap" and mv.policy == "energy_bias":
                return _sample_energy_bias(config, kinds, theta, generator, system, cell, q, *mv.species, block)
        raise ValueError(f"move {m} ({mv.action}/{mv.policy}) has no learnable policy")

    def surrogate_at(prop, theta, m, system, cell):
        lqf, lqr = logq_fns[m](prop, system, cell, theta)
        with torch.no_grad():
            e1, e2 = delta_e(system, cell, prop)
        temperature = system.temperature.reshape((-1,) + (1,) * (prop.i.dim() - 1))
        log_alpha = -(e2 - e1) / temperature + lqr - lqf
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        A = torch.minimum(torch.ones_like(log_alpha), torch.exp(log_alpha))
        R = rewards[m](prop, system).detach()
        ratio = torch.exp(lqf - lqf.detach())
        return ratio * A * R, lqf

    return sample_prop, surrogate_at


class PGMC:
    """Estimator and updater bound to a Simulation (engine/simulation.py)."""

    def __init__(self, sim, optimisers: Tuple, q_batch_size: int = 10):
        self.sim = sim
        pool = sim.pool
        if len(optimisers) != len(pool):
            raise ValueError("one optimiser per move in pool order (reference contract)")
        if any(m.policy == "smart" for m in pool):
            raise ValueError(
                "PGMC does not support the SmartGaussian (force-bias) "
                "policy: its proposal density depends on the state through "
                "the drift, which the global-proposal estimator surrogate "
                "does not model — use SimpleGaussian for learnable sigma"
            )
        self.optimisers = tuple(optimisers)
        self.q_batch_size = int(q_batch_size)
        self.learnable = [len(m.params) > 0 for m in pool]

        # The estimator needs only π-samples (the chains' states, from
        # whichever backend advances them) and fresh proposals with their
        # ΔE, so on the checkerboard backend it runs the dense ΔE on the
        # sampler's system. There the objective of the global proposal is a
        # proxy for the kernel's in-cell displacement, accurate while σ is
        # well below the cell side; past side/4 update() warns.
        self._sigma_proxy_limit = None
        if sim.parallel_moves:
            config = K.KernelConfig(pool=pool, table=sim.chains.table, cell_spec=None)
            box0 = sim.chains.states.box[0].double().cpu().numpy()
            side = float(np.min(box0 / np.asarray(sim.cb_spec.ncells, np.float64)))
            self._sigma_proxy_limit = side / 4.0
        else:
            config = sim.config
        self.config = config
        self._has_cell = config.cell_spec is not None
        # (sample_prop, surrogate_at) with the pair table on each shard's device
        self._shard_fns = sim.per_shard_device(
            lambda table: build_surrogate_fns(dataclasses.replace(config, table=table), sim.chains.n_particles)
        )
        self.sample_prop, self.surrogate_at = self._shard_fns[0]
        self._acc = [None] * len(pool)  # [g_sum [P], fisher_sum [P, P], count]
        self.generator = torch.Generator(device=sim.device)
        self.generator.manual_seed(sim.seed + 777)
        # one generator per chain shard, in step with the first
        self._generators = [self.generator] + [
            PM.copy_generator(self.generator, s.system.position.device) for s in sim.shards[1:]
        ]

    # ------------------------------------------------------------------
    def per_chain(self, m: int, prop=None):
        """One estimate of move m per chain: the gradient g [M, P] (the mean
        over the chain's q_batch_size samples) and the Fisher matrix
        F [M, P, P] (scoresᵀ scores / q_batch_size), the P parameters in
        sorted name order, on the first chains' device. `prop` feeds in the
        actions (an Action [M, Q]); otherwise they are drawn from the
        estimator's generator. Each chain shard evaluates its own chains."""
        sim = self.sim
        parts = [
            self._shard_per_chain(mc, params[m], gen, fns, m, prop)
            for mc, params, gen, fns in zip(sim.shards, sim.shard_params, self._generators, self._shard_fns)
        ]
        if len(parts) == 1:
            return parts[0]
        dev = parts[0][0].device
        return tuple(torch.cat([part[k].to(dev) for part in parts]) for k in range(2))

    def _shard_per_chain(self, mc, p, gen, fns, m: int, prop):
        sample_prop, surrogate_at = fns
        st = mc.system
        cell = mc.cell if self._has_cell else None
        names = sorted(p)
        M = st.n_chains
        if prop is None:
            Q = self.q_batch_size
            prop = sample_prop(p, m, gen, st, cell, Q, mc.chains)
        else:
            prop = K.Action(*(own_rows(x, mc.chains) for x in prop))
            Q = prop.i.shape[1]
        with torch.enable_grad():
            theta = {k: p[k].detach().expand(M, Q).clone().requires_grad_(True) for k in names}
            leaves = [theta[k] for k in names]
            val, lqf = surrogate_at(prop, theta, m, st, cell)
            g = torch.stack(torch.autograd.grad(val.sum(), leaves, retain_graph=True), dim=-1)  # [M, Q, P]
            s = torch.stack(torch.autograd.grad(lqf.sum(), leaves), dim=-1)
        return g.mean(dim=1), s.transpose(1, 2) @ s / Q

    def estimate(self, props=None):
        """Accumulate one gradient estimate per learnable move, averaged
        over every chain (of every shard). `props` feeds in the actions: one
        Action [M, Q] per pool move (None for a move without parameters)."""
        for m, learn in enumerate(self.learnable):
            if not learn:
                continue
            g, fisher = self.per_chain(m, None if props is None else props[m])
            g, fisher = g.mean(dim=0), fisher.mean(dim=0)
            if self._acc[m] is None:
                self._acc[m] = [g, fisher, 1]
            else:
                self._acc[m][0] = self._acc[m][0] + g
                self._acc[m][1] = self._acc[m][1] + fisher
                self._acc[m][2] += 1

    def update(self):
        """Apply each move's optimiser step to the mean of its accumulated
        estimates, then reset the accumulator."""
        params = list(self.sim.pool_params)
        for m, acc in enumerate(self._acc):
            if acc is None:
                continue
            g, fisher, cnt = acc
            g, fisher = g / cnt, fisher / cnt
            opt = self.optimisers[m]
            if isinstance(opt, BLANPG):
                eye = torch.eye(g.shape[0], dtype=fisher.dtype, device=fisher.device)
                step = opt.lr * torch.linalg.solve_ex(fisher + opt.reg * eye, g).result
            elif isinstance(opt, VPG):
                step = opt.lr * g
            else:
                raise ValueError(f"unknown optimiser {opt}")
            p = params[m]
            params[m] = {k: p[k] + step[off].to(p[k].dtype) for off, k in enumerate(sorted(p))}
            self._acc[m] = None
            if self._sigma_proxy_limit is not None and "sigma" in params[m]:
                s = float(params[m]["sigma"].abs().max())
                if s > self._sigma_proxy_limit:
                    warnings.warn(
                        f"PGMC-learned sigma = {s:.4g} exceeds cell_side/4 = "
                        f"{self._sigma_proxy_limit:.4g}: the global-proposal "
                        "objective used by the estimator on the checkerboard "
                        "backend stops tracking the in-cell-truncated kernel "
                        "here — the learned sigma may be off-optimum. "
                        "Validate it against a direct sigma sweep of the "
                        "checkerboard kernel, or learn on the sequential "
                        "kernel at this width.",
                        RuntimeWarning,
                        stacklevel=2,
                    )
        self.sim.pool_params = tuple(params)

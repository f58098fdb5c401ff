"""The plain reference sampler for pools that mix Gaussian displacements
with species swaps: sequential Metropolis-Hastings, dense, one move per
chain per step, as the reference ParticlesMC defines the moves
(src/moves.jl:34-123 Displacement + SimpleGaussian, :137-214 DiscreteSwap,
:226-241 DoubleUniform, :246-280 EnergyBias).

Each step every chain picks one move of the pool with the pool's
probabilities:
- `displacement` (sigma): particle i uniform over all N, moved by sigma
  times a standard normal vector and folded into the box; symmetric.
- `discrete_swap` (s1, s2; policy `double_uniform`): i uniform among the
  particles of species s1, j uniform among those of s2, and the two
  exchange their species in place; q = 1 / (n1 n2) both ways.
- `discrete_swap` with policy `energy_bias` (theta1, theta2): i drawn from
  species s1 with probability exp(theta1 E_i) / sum_{k in s1} exp(theta1
  E_k), j from s2 likewise with theta2, E the per-particle energies (each
  particle's pair energy against all others); the reverse move, picking j
  (now of s1) and i (now of s2), has its density evaluated in the
  post-swap configuration, and the acceptance takes the Hastings term
  log q_rev - log q_fwd. DoubleUniform is this at theta1 = theta2 = 0.

The energy change of a move is that of the particles it touches: E_i after
less E_i before for a displacement, (E_i + E_j) after less before for a
swap (the i-j pair's own term is the same either way). Every step
evaluates every particle's energy in the proposed configuration, dense
over all pairs in blocks; the squared distances are taken in the
positions' type and the potential evaluated in `compute`, the ledger kept
in float64.

Its acceptance per move, in float64 from a state of the window (its
start or its end, cell.py's `acceptance_span`), is what the program's acceptance of each move
is judged against (`acceptance`, which cell.py finds by the traffic's
`reference_sampler`); in a lower `compute` it is the control put in the
program's place (control.py). It imports nothing of the program under
test.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.energy import pair_blocks, pair_tables, total_energy


def particle_energies(x, species, box, f, tab, S, compute):
    """[B, N] each particle's energy against every other particle of its
    chain (minimum image), evaluated in `compute`: x [B, N, d], species
    [B, N], box [B, d], `tab` the [S, S] pair coefficients in `compute`."""
    B, n, _ = x.shape
    out = torch.zeros((B, n), dtype=compute, device=x.device)
    cols = torch.arange(n, device=x.device)
    for cs, rs in pair_blocks(B, n):
        L = box[cs].to(x.dtype)[:, None, None, :]
        dx = x[cs, rs, None, :] - x[cs, None, :, :]
        dx = dx - torch.round(dx / L) * L
        r2 = (dx * dx).sum(dim=-1).to(compute)
        self_pair = cols[rs, None] == cols[None, :]
        r2 = torch.where(self_pair, torch.full_like(r2, math.inf), r2)
        pair = species[cs, rs, None] * S + species[cs, None, :]
        c = {k: v.reshape(-1)[pair] for k, v in tab.items()}
        out[cs, rs] = f.energy(r2, c).sum(dim=-1)
    return out


def gumbel_pick(logits, generator):
    """[B] one index per row drawn with probability softmax(logits) (the
    largest of logits plus Gumbel noise); -inf logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float64)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float64).tiny)))
    return torch.argmax(logits.double() + g, dim=-1)


def log_pick(e, species, s, theta, k):
    """[B] log of the probability that EnergyBias picks particle k [B] from
    species s [B] at weight exp(theta E), over energies e [B, N]."""
    logits = torch.where(species == s[:, None], theta[:, None] * e, -math.inf)
    return logits.gather(1, k[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)


def moves_of(pool: list, device) -> dict:
    """The pool as per-move tensors [M]: the cumulative probabilities and
    each move's kind (0 displacement, 1 swap), sigma, s1, s2, theta1 and
    theta2 (0 where the move has none)."""
    rows = []
    for mv in pool:
        a = mv["args"]
        policy = a.get("policy", "double_uniform")
        if mv["move"] == "displacement":
            rows.append((0, float(a["sigma"]), 0, 0, 0.0, 0.0))
        elif mv["move"] == "discrete_swap" and policy in ("double_uniform", "energy_bias"):
            bias = policy == "energy_bias"
            rows.append((1, 0.0, int(a["s1"]), int(a["s2"]),
                         float(a["theta1"]) if bias else 0.0, float(a["theta2"]) if bias else 0.0))
        else:
            raise NotImplementedError(f"the swap sampler runs displacements and discrete swaps, not {mv}")
    p = torch.tensor([float(mv["args"].get("probability", 1.0)) for mv in pool], dtype=torch.float64)
    out = {"cum": torch.cumsum(p / p.sum(), 0)[:-1].to(device)}
    for k, (name, dt) in enumerate((("kind", torch.int64), ("sigma", torch.float64), ("s1", torch.int64),
                                    ("s2", torch.int64), ("theta1", torch.float64), ("theta2", torch.float64))):
        out[name] = torch.tensor([r[k] for r in rows], dtype=dt, device=device)
    return out


def metropolis(position, species, box, temperature, potential, pool, steps, generator, compute=torch.float64):
    """`steps` sequential Metropolis-Hastings steps of every chain with the
    traffic's `pool` at `temperature` [B]; returns the positions, the
    species, the float64 ledger's start and end, and the attempted and
    accepted moves per chain and move of the pool, [B, M]."""
    B, n, d = position.shape
    dev = position.device
    f, tab = pair_tables(potential, dev)
    S = tab["eps4"].shape[0]
    tab = {k: v.to(compute) for k, v in tab.items()}
    P = moves_of(pool, dev)
    M = P["kind"].shape[0]
    x, sp = position.clone(), species.clone()
    L = box.to(x.dtype)
    ledger0 = total_energy(x, sp, box, potential)
    ledger = ledger0.clone()
    rows = torch.arange(B, device=dev)
    attempted = torch.zeros((B, M), dtype=torch.int64, device=dev)
    accepted = torch.zeros((B, M), dtype=torch.int64, device=dev)
    one = torch.ones((B, 1), dtype=torch.int64, device=dev)
    e = particle_energies(x, sp, L, f, tab, S, compute)
    for _ in range(int(steps)):
        u_move = torch.rand(B, generator=generator, device=dev, dtype=torch.float64)
        m = (u_move[:, None] >= P["cum"][None, :]).sum(dim=-1)
        swap = P["kind"][m] == 1
        # a displacement of particle i
        i_d = torch.randint(n, (B,), generator=generator, device=dev)
        step = P["sigma"][m].to(x.dtype)[:, None] * torch.randn((B, d), generator=generator, device=dev, dtype=x.dtype)
        x_new = x[rows, i_d] + step
        x_new = x_new - torch.floor(x_new / L) * L
        # a swap of i (species s1) and j (species s2)
        s1, s2, th1, th2 = P["s1"][m], P["s2"][m], P["theta1"][m], P["theta2"][m]
        e64 = e.double()
        i_s = gumbel_pick(torch.where(sp == s1[:, None], th1[:, None] * e64, -math.inf), generator)
        j_s = gumbel_pick(torch.where(sp == s2[:, None], th2[:, None] * e64, -math.inf), generator)
        u = torch.rand(B, generator=generator, device=dev, dtype=torch.float64)

        i = torch.where(swap, i_s, i_d)
        j = torch.where(swap, j_s, i_d)
        x2 = x.clone()
        x2[rows, i] = torch.where(swap[:, None], x[rows, i], x_new)
        sp2 = sp.clone()
        sp2[rows, i] = torch.where(swap, sp[rows, j], sp[rows, i])
        sp2[rows, j] = torch.where(swap, sp[rows, i], sp2[rows, j])
        e2 = particle_energies(x2, sp2, L, f, tab, S, compute)
        pair = swap.to(compute)
        de = ((e2[rows, i] + pair * e2[rows, j]) - (e[rows, i] + pair * e[rows, j])).double()
        e2_64 = e2.double()
        log_q_fwd = log_pick(e64, sp, s1, th1, i) + log_pick(e64, sp, s2, th2, j)
        log_q_rev = log_pick(e2_64, sp2, s1, th1, j) + log_pick(e2_64, sp2, s2, th2, i)
        valid = (sp == s1[:, None]).any(dim=-1) & (sp == s2[:, None]).any(dim=-1)
        hastings = torch.where(swap, torch.where(valid, log_q_rev - log_q_fwd, -math.inf), 0.0)
        log_alpha = -de / temperature.double() + hastings
        accept = torch.log(u) < torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)

        ledger += torch.where(accept, de, torch.zeros_like(de))
        x = torch.where(accept[:, None, None], x2, x)
        sp = torch.where(accept[:, None], sp2, sp)
        e = torch.where(accept[:, None], e2, e)
        attempted.scatter_add_(1, m[:, None], one)
        accepted.scatter_add_(1, m[:, None], accept.long()[:, None])
    return x, sp, ledger0, ledger, attempted, accepted


def acceptance(cfg: dict, trf: dict, position, species, box, steps: int, generator):
    """([attempted], [accepted]) per move of the traffic's pool, summed
    over the chains: `steps` float64 steps from `position` and `species`
    at the configuration's temperature."""
    B = position.shape[0]
    temp = torch.full((B,), float(cfg["system"]["temperature"]), dtype=torch.float64, device=position.device)
    *_, att, acc = metropolis(position.double(), species, box.double(), temp, cfg["potential"], trf["pool"],
                              int(steps), generator, compute=torch.float64)
    return att.sum(dim=0).tolist(), acc.sum(dim=0).tolist()

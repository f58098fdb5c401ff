"""Pair-potential math on squared distances (counterpart of
particlesmc_tpu/models/potentials.py).

One branch-free evaluation serves every potential kind: each functional form
is computed and the active one selected by the integer `kind` of the species
pair. The operation order follows the reference, so float64 results agree to
the last few ulps.

Potential kinds
---------------
0: none (no interaction)
1: inverse power  u = eps * (sigma^2 / r^2)^(n/2) - shift      (SoftSpheres)
2: Lennard-Jones  u = 4 eps [(s2/r2)^6 - (s2/r2)^3] - shift    (LennardJones)
3: smooth LJ      u = lj + 4 eps (C0 + C2 r2/s2 + C4 r4/s4)    (SmoothLennardJones)

Bonded pairs (GeneralKG, Trimer) add a FENE spring and a shifted-LJ core
(bond_potential), evaluated only over each particle's bond list.
"""

from __future__ import annotations

import torch

KIND_NONE = 0
KIND_INVERSE_POWER = 1
KIND_LENNARD_JONES = 2
KIND_SMOOTH_LJ = 3

# every field pair_potential can read, in the order the CUDA kernel's packed
# table uses (moves/cb_cuda.py)
PAIR_FIELDS = ("kind", "eps4", "sigma2", "ipl_n", "rcut2", "shift", "c0", "c2s2", "c4s4")


def lj_unshifted(r2, eps4, sigma2):
    """4*eps*[(s2/r2)^6 - (s2/r2)^3]."""
    x = sigma2 / r2
    x3 = x * x * x
    return eps4 * (x3 * x3 - x3)


def _int_pow(y, n_int, nbits: int = 6):
    """y**n by square-and-multiply for an integer tensor 0 <= n < 2^nbits.

    A floating-point pow goes through exp(log(..)); chained multiplies keep
    full precision, which the golden-energy gates (1e-6 absolute) need."""
    acc = torch.ones_like(y)
    sq = y
    for k in range(nbits):
        bit = (n_int >> k) & 1
        acc = torch.where(bit == 1, acc * sq, acc)
        sq = sq * sq
    return acc


def inverse_power(r2, eps, sigma2, n_int):
    """eps * (sigma2/r2)^(n/2), n integer."""
    return eps * _int_pow(torch.sqrt(sigma2 / r2), n_int)


def fene(r2, kr02, r02):
    """FENE bond term kr02 * log(1 - r2/r02), kr02 = -k r0^2/2. The caller
    guards r2 > r02 (bond_potential gives +inf there)."""
    return kr02 * torch.log(1.0 - r2 / r02)


def pair_fields_needed(kinds_present=None):
    """The per-pair parameter fields pair_potential reads for these kinds."""
    if kinds_present is None:
        return PAIR_FIELDS
    kp = tuple(kinds_present)
    need = ["eps4", "sigma2", "rcut2"]
    if len(kp) > 1 or KIND_NONE in kp:
        need.append("kind")
    if KIND_INVERSE_POWER in kp:
        need.append("ipl_n")
    if KIND_INVERSE_POWER in kp or KIND_LENNARD_JONES in kp:
        need.append("shift")
    if KIND_SMOOTH_LJ in kp:
        need += ["c0", "c2s2", "c4s4"]
    return tuple(dict.fromkeys(need))


def pair_potential(r2, p, kinds_present=None):
    """Pair potential for per-pair parameters `p` gathered to r2's shape.

    `p` has tensor attributes (kind, eps4, sigma2, ipl_n, shift, c0, c2s2,
    c4s4, rcut2), see tables.gather_pair. u = 0 for r2 > rcut2 (r2 == rcut2
    stays in range) and for kind 0. `kinds_present` (the static tuple from
    tables.kinds_present) skips the forms that do not occur; None keeps all.
    r2 is clamped at 1e-12 so that masked self pairs stay finite.
    """
    kp = (
        (KIND_INVERSE_POWER, KIND_LENNARD_JONES, KIND_SMOOTH_LJ)
        if kinds_present is None
        else tuple(kinds_present)
    )
    r2s = torch.clamp_min(r2, 1e-12)
    x = p.sigma2 / r2s
    x3 = x * x * x
    need_lj = KIND_LENNARD_JONES in kp or KIND_SMOOTH_LJ in kp
    lj = p.eps4 * (x3 * x3 - x3) if need_lj else None

    if kp == (KIND_LENNARD_JONES,):
        u = lj - p.shift
    elif kp == (KIND_INVERSE_POWER,):
        u = p.eps4 * _int_pow(torch.sqrt(x), p.ipl_n) - p.shift
    elif kp == (KIND_SMOOTH_LJ,):
        u = lj + p.eps4 * (p.c0 + r2s * (p.c2s2 + r2s * p.c4s4))
    else:
        kind = p.kind
        u = torch.zeros_like(x3)
        if KIND_SMOOTH_LJ in kp:
            smooth_add = p.eps4 * (p.c0 + r2s * (p.c2s2 + r2s * p.c4s4))
            u = torch.where(kind == KIND_SMOOTH_LJ, lj + smooth_add, u)
        if KIND_LENNARD_JONES in kp:
            u = torch.where(kind == KIND_LENNARD_JONES, lj - p.shift, u)
        if KIND_INVERSE_POWER in kp:
            ipl = p.eps4 * _int_pow(torch.sqrt(x), p.ipl_n)
            u = torch.where(kind == KIND_INVERSE_POWER, ipl - p.shift, u)

    in_range = r2 <= p.rcut2
    if kinds_present is not None and KIND_NONE not in kp and len(kp) > 0:
        mask = in_range
    else:
        mask = in_range & (p.kind != KIND_NONE)
    return torch.where(mask, u, torch.zeros_like(u))


def pair_virial(r2, p, kinds_present=None):
    """Pair virial w = -2 r^2 dU/dr^2 = r f(r) for the non-bonded kinds.

    The force on particle a from a lane at separation dx = x_nb - x_a is
    F_j = -(w / r^2) dx_j (the force-bias displacement's drift). Shifts do
    not contribute. `kinds_present` prunes the forms as in pair_potential.
    """
    kp = (
        (KIND_INVERSE_POWER, KIND_LENNARD_JONES, KIND_SMOOTH_LJ)
        if kinds_present is None
        else tuple(kinds_present)
    )
    r2s = torch.clamp_min(r2, 1e-12)
    x = p.sigma2 / r2s
    x3 = x * x * x
    need_lj = KIND_LENNARD_JONES in kp or KIND_SMOOTH_LJ in kp
    w_lj = p.eps4 * (12.0 * x3 * x3 - 6.0 * x3) if need_lj else None

    if kp == (KIND_LENNARD_JONES,):
        w = w_lj
    elif kp == (KIND_INVERSE_POWER,):
        w = p.eps4 * p.ipl_n * _int_pow(torch.sqrt(x), p.ipl_n)
    elif kp == (KIND_SMOOTH_LJ,):
        w = w_lj - 2.0 * r2s * p.eps4 * (p.c2s2 + 2.0 * r2s * p.c4s4)
    else:
        kind = p.kind
        w = torch.zeros_like(x3)
        if KIND_SMOOTH_LJ in kp:
            w_smooth = w_lj - 2.0 * r2s * p.eps4 * (p.c2s2 + 2.0 * r2s * p.c4s4)
            w = torch.where(kind == KIND_SMOOTH_LJ, w_smooth, w)
        if KIND_LENNARD_JONES in kp:
            w = torch.where(kind == KIND_LENNARD_JONES, w_lj, w)
        if KIND_INVERSE_POWER in kp:
            w_ipl = p.eps4 * p.ipl_n * _int_pow(torch.sqrt(x), p.ipl_n)
            w = torch.where(kind == KIND_INVERSE_POWER, w_ipl, w)

    in_range = r2 <= p.rcut2
    if kinds_present is not None and KIND_NONE not in kp and len(kp) > 0:
        mask = in_range
    else:
        mask = in_range & (p.kind != KIND_NONE)
    return torch.where(mask, w, torch.zeros_like(w))


def bond_virial(r2, p):
    """Bond virial of the FENE spring and the shifted-LJ core,
    w = -2 r^2 dU/dr^2."""
    r2s = torch.clamp_min(r2, 1e-12)
    r02s = torch.where(p.r02 > 0, p.r02, torch.ones_like(p.r02))
    denom = torch.clamp_min(r02s - r2s, 1e-12)
    w_fene = 2.0 * r2s * p.kr02 / denom
    w_fene = torch.where(r2 <= p.r02, w_fene, torch.zeros_like(w_fene))
    x = p.sigma2b / r2s
    x3 = x * x * x
    w_lj = p.eps4b * (12.0 * x3 * x3 - 6.0 * x3)
    w_lj = torch.where(r2 <= p.rcut2b, w_lj, torch.zeros_like(w_lj))
    return torch.where(p.has_bond > 0, w_fene + w_lj, torch.zeros_like(r2s))


def bond_potential(r2, p):
    """Bonded interaction: FENE spring + shifted LJ core.

      u_fene = kr02 * log(1 - r2/r0^2) for r2 <= r0^2, else +inf
      u_lj   = lj(r2; eps4b, sigma2b) - shiftb for r2 <= rcutbond^2, else 0
    Pairs without a bond term (has_bond == 0) give 0.
    """
    r2s = torch.clamp_min(r2, 1e-12)
    inf = torch.full_like(r2s, float("inf"))
    r02s = torch.where(p.r02 > 0, p.r02, torch.ones_like(p.r02))
    arg = 1.0 - r2s / r02s
    u_fene = p.kr02 * torch.log(torch.clamp_min(arg, 1e-30))
    u_fene = torch.where(r2 <= p.r02, u_fene, inf)
    x = p.sigma2b / r2s
    x3 = x * x * x
    u_lj = p.eps4b * (x3 * x3 - x3) - p.shiftb
    u_lj = torch.where(r2 <= p.rcut2b, u_lj, torch.zeros_like(u_lj))
    u = u_fene + u_lj
    return torch.where(p.has_bond > 0, u, torch.zeros_like(u))

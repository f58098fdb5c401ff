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

"""Inputs shared by the port's tests, made from a seed with numpy.

This module imports neither JAX nor the JAX package, so that the card-only
tests (tests/test_torch_cuda.py) can use it on a machine without JAX."""

import numpy as np

SIDE = 2.6  # cell side >= the largest cutoff of the KA and JBB tables (2.5)


def lattice(n, d, density, seed):
    """A cubic lattice of n sites at `density`, jittered by 3% of the
    spacing; 20% of the particles are species 2, the rest species 1."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per = int(np.ceil(n ** (1 / d)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1)
    pos = grid.reshape(-1, d)[:n] + rng.uniform(-0.03 * a, 0.03 * a, (n, d))
    species = (rng.random(n) < 0.2).astype(np.int64) + 1
    return pos, species


def ka2d(m, n_side=None, density=1.1920748468939728, seed=42):
    """tests/test_pgmc.py's start: m jittered 2D lattices of N = 43
    (species 1:2:3 as 20:11:12, the reference PGMC scenario's) or of
    n_side^2 particles (half species 1, a quarter each 2 and 3), species
    1-based and shuffled per chain; returns positions [m, N, 2], species
    [m, N] and the density."""
    rng = np.random.default_rng(seed)
    if n_side is None:
        n, per, counts = 43, 7, (20, 11, 12)
    else:
        n, per = n_side * n_side, n_side
        counts = (n - 2 * (n // 4), n // 4, n // 4)
    L = (n / density) ** 0.5
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * 2, indexing="ij"), -1).reshape(-1, 2)[:n]
    pos, sps = [], []
    for _ in range(m):
        pos.append(grid + rng.uniform(-0.05 * a, 0.05 * a, (n, 2)))
        sp = np.concatenate([np.full(c, s + 1) for s, c in enumerate(counts)])
        rng.shuffle(sp)
        sps.append(sp)
    return np.stack(pos), np.stack(sps), density


def make_inputs(d, cap, inner, n_species, chains=2, A=4, seed=0):
    """Random packed lanes of A cells per chain for the colour substep: each
    centre cell and its 3^d - 1 neighbours hold a random number of particles
    placed uniformly in their cube, empty lanes carry species -1. Cell 0 is
    full and cell A - 1 empty in every chain."""
    rng = np.random.default_rng(seed)
    offsets = [np.zeros(d, int)] + [
        np.array(t) for t in np.ndindex(*(3,) * d) if any(np.array(t) != 1)
    ]
    offsets = [o if i == 0 else o - 1 for i, o in enumerate(offsets)]
    LP = len(offsets) * cap
    lo = rng.uniform(0.0, 3 * SIDE, (d, A))
    hi = lo + SIDE
    pos = np.zeros((chains, d, A, LP))
    sp = -np.ones((chains, A, LP))
    for b in range(chains):
        for a in range(A):
            for blk, off in enumerate(offsets):
                occ = cap if (blk == 0 and a == 0) else rng.integers(0, cap + 1)
                if blk == 0 and a == A - 1:
                    occ = 0
                lanes = slice(blk * cap, blk * cap + occ)
                low = lo[:, a] + off * SIDE
                pos[b, :, a, lanes] = rng.uniform(low, low + SIDE, (occ, d)).T
                sp[b, a, lanes] = rng.integers(0, n_species, occ)
    up = rng.uniform(0.0, 1.0 - 1e-7, (chains, inner, A))
    dl = rng.normal(0.0, 0.4, (chains, inner, d, A))
    thr = -1.3 * np.log(rng.uniform(1e-300, 1.0, (chains, inner, A)))
    return pos, sp, up, dl, thr, lo, hi


def mixed_table(dtype, device):
    """A 3-species pair table of the port with every potential kind: LJ,
    inverse power and smooth LJ pairs, and one pair without interaction
    (kind 0). All cutoffs are below SIDE."""
    from particlesmc_tpu_torch.models import tables as TT

    lj, ipl, slj = TT.lennard_jones, TT.soft_spheres, TT.smooth_lennard_jones
    e01, e02, e12 = ipl(1.0, 1.1, 12), TT._base_entry(), lj(1.5, 0.8)
    entries = [
        [lj(1.0, 1.0), e01, e02],
        [e01, slj(0.5, 0.9), e12],
        [e02, e12, slj(0.75, 0.94)],
    ]
    return TT.build_pair_table(entries, dtype, device)


def trimer_melt(n_mol, density, seed):
    """A melt of n_mol equilateral trimers (species 1, 2, 3, bonded all to
    all) on a cubic lattice of molecule centres, jittered by 0.02:
    positions [3 n_mol, 3], species, molecule ids (1-based) and per-particle
    bond lists."""
    rng = np.random.default_rng(seed)
    n, d = 3 * n_mol, 3
    L = (n / density) ** (1 / d)
    per = int(np.ceil(n_mol ** (1 / d)))
    a = L / per
    centres = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n_mol]
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, 0.866, 0.0]])
    pos = (centres[:, None, :] + tri[None]).reshape(n, d) + rng.uniform(-0.02, 0.02, (n, d))
    bonds = [[3 * (k // 3) + o for o in range(3) if o != k % 3] for k in range(n)]
    return pos, np.tile([1, 2, 3], n_mol), np.repeat(np.arange(1, n_mol + 1), 3), bonds


def wide_config(ncx=16, ncy=4, seed=0, rcut=2.5):
    """tests/test_spatial.py's _wide_system recipe: a 2D box of (ncx, ncy)
    cells at the cutoff, a jittered rectangular lattice at density 0.6, 30%
    species 2. Returns positions, 1-based species, box and density."""
    rng = np.random.default_rng(seed)
    box = np.array([ncx * rcut * 1.01, ncy * rcut * 1.01])
    density = 0.6
    n = int(density * box[0] * box[1])
    ny = max(1, int(np.sqrt(n / (box[0] / box[1]))))
    nx = int(np.ceil(n / ny))
    xs, ys = np.meshgrid((np.arange(nx) + 0.5) * box[0] / nx, (np.arange(ny) + 0.5) * box[1] / ny, indexing="ij")
    pos = np.stack([xs.reshape(-1), ys.reshape(-1)], -1)[:n] + rng.uniform(-0.05, 0.05, (n, 2))
    species = (rng.random(n) < 0.3).astype(np.int64) + 1
    return pos, species, box, density

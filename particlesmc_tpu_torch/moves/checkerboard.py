"""Checkerboard hyper-sweep for atomic displacement pools (counterpart of
particlesmc_tpu/moves/checkerboard.py).

Domain-decomposition Metropolis: particles are binned into a grid of cells
of side >= rcut (an even count per dimension) under a random origin shift
drawn per rebin block. A colour substep activates one of the 2^d
checkerboard sublattices; active cells are at least one cell apart, so one
move per active cell is independent of every other. Each active cell runs
`inner` sequential sub-moves (uniform pick, Gaussian proposal, rejection of
a proposal that leaves the cell, Metropolis accept) against its own lanes
and the 3^d - 1 neighbour cells, which stay static for the substep. The
colours cycle in a fixed order; the per-block shift restores ergodicity
across cell boundaries. A block whose binning overflows a bucket is the
identity (skip-on-overflow), which keeps the chain unbiased.

Layout: plane payload [B, d+1, cells, cap] (shifted-frame positions, then
species as floats with -1 for empty), kept in a wrap-padded grid whose halo
faces are image-corrected so that every in-substep distance is a plain
coordinate difference. The inner loop of a substep is the CUDA kernel of
moves/cb_cuda.py; the binning, neighbour extraction, halo refresh and unbin
are plain PyTorch.

Only all-SimpleGaussian displacement pools on atomic systems are ported;
everything else raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.geometry import fold_back
from ..core.state import SystemState
from ..models.tables import PairTable
from ..runtime import unported
from .cb_cuda import disp_substep, pack_table


@dataclasses.dataclass(frozen=True)
class CBSpec:
    """Static checkerboard grid geometry."""

    ncells: Tuple[int, ...]  # per dim, even, >= 4
    cap: int  # bucket capacity

    @property
    def d(self) -> int:
        return len(self.ncells)

    @property
    def total(self) -> int:
        return int(np.prod(self.ncells))

    @property
    def active_dims(self) -> Tuple[int, ...]:
        return tuple(n // 2 for n in self.ncells)

    @property
    def n_active(self) -> int:
        return int(np.prod(self.active_dims))


def make_cb_spec(
    box, rcut: float, n: int, cap: Optional[int] = None, occ_factor: float = 2.5
) -> Optional[CBSpec]:
    """Even-count grid with cell side >= rcut; None if the box is too small
    (fewer than 4 cells in some dimension). `occ_factor` scales the default
    bucket capacity over the mean occupancy."""
    box = np.asarray(box, np.float64)
    nc = np.floor(box / rcut).astype(int)
    nc = nc - (nc % 2)
    if nc.min() < 4:
        return None
    if cap is None:
        mean_occ = n / float(np.prod(nc))
        cap = max(4, int(math.ceil(mean_occ * occ_factor)))
    return CBSpec(ncells=tuple(int(x) for x in nc), cap=int(cap))


@dataclasses.dataclass(frozen=True)
class CBState:
    """Sampler state of B chains under the checkerboard kernel.

    `generator` supplies every random draw; hyper-sweeps advance it in place.
    """

    system: SystemState
    generator: torch.Generator
    shift: torch.Tensor  # [B, d] grid origin offset
    planes: torch.Tensor  # [B, d+1, cells, cap] shifted positions + species
    idx: torch.Tensor  # [B, cells, cap] particle ids, -1 padded
    slot: torch.Tensor  # [B, n] flat payload slot of each particle
    attempted: torch.Tensor  # [B, n_moves]
    accepted: torch.Tensor  # [B, n_moves]
    overflow: torch.Tensor  # [B] sticky: some block was skipped
    skipped: torch.Tensor  # [B] count of skipped rebin blocks

    def replace(self, **kw) -> "CBState":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Binning. Payload positions are in the shifted frame x' = fold(x - shift):
# cell c spans [c*L/nc, (c+1)*L/nc) per dimension and no cell straddles the
# box boundary.
# ---------------------------------------------------------------------------


def rebin(system: SystemState, spec: CBSpec, shift):
    """Bin every chain: returns planes [B, d+1, cells, cap], idx
    [B, cells, cap], slot [B, n] and overflow [B].

    A stable sort by cell key orders the particles; each cell's run is then
    cut into its `cap` lanes (searchsorted gives the run bounds)."""
    B, n, d = system.position.shape
    dt = system.position.dtype
    dev = system.position.device
    box = system.box[:, None, :]
    xs = fold_back(system.position - shift[:, None, :], box)
    nc = torch.tensor(spec.ncells, device=dev)
    cvec = torch.clamp(torch.floor(xs / box * nc.to(dt)).long(), torch.zeros_like(nc), nc - 1)
    cell = cvec[..., 0]
    for k in range(1, d):
        cell = cell * spec.ncells[k] + cvec[..., k]
    sorted_cell, perm = torch.sort(cell, dim=-1, stable=True)
    comps = torch.cat([xs.transpose(1, 2), system.species.to(dt)[:, None, :]], dim=1)
    np_ = d + 1
    sorted_comps = torch.gather(comps, 2, perm[:, None, :].expand(B, np_, n))
    cells_iota = torch.arange(spec.total, device=dev).expand(B, spec.total).contiguous()
    first = torch.searchsorted(sorted_cell, cells_iota, side="left")
    nxt = torch.searchsorted(sorted_cell, cells_iota, side="right")

    p = first[..., None] + torch.arange(spec.cap, device=dev)  # [B, cells, cap]
    valid = p < nxt[..., None]
    pc = torch.clamp(p, max=n - 1).reshape(B, -1)
    fills = torch.tensor([0.0] * d + [-1.0], dtype=dt, device=dev)[None, :, None, None]
    taken = torch.gather(sorted_comps, 2, pc[:, None, :].expand(B, np_, pc.shape[1]))
    planes = torch.where(
        valid[:, None], taken.reshape(B, np_, spec.total, spec.cap), fills
    )
    idx = torch.where(
        valid, torch.gather(perm, 1, pc).reshape(B, spec.total, spec.cap), -1
    )
    # particle -> flat payload slot: rank within its cell's run, scattered
    # back to particle order
    iota_n = torch.arange(n, device=dev).expand(B, n)
    boundary = torch.ones_like(sorted_cell, dtype=torch.bool)
    boundary[:, 1:] = sorted_cell[:, 1:] != sorted_cell[:, :-1]
    start_pos = torch.cummax(torch.where(boundary, iota_n, 0), dim=1).values
    rank = iota_n - start_pos
    slot_sorted = sorted_cell * spec.cap + torch.clamp(rank, max=spec.cap - 1)
    slot = torch.zeros_like(sorted_cell).scatter_(1, perm, slot_sorted)
    overflow = torch.any(nxt - first > spec.cap, dim=-1)
    return planes, idx, slot, overflow


def unbin_positions(planes, idx, n: int, shift, box):
    """Scatter payload positions back into global [B, N, d] positions."""
    B = planes.shape[0]
    d = box.shape[-1]
    flat_idx = idx.reshape(B, -1)
    tgt = torch.where(flat_idx >= 0, flat_idx, n)  # padding goes to a dropped column
    cols = []
    for j in range(d):
        col = torch.zeros((B, n + 1), dtype=planes.dtype, device=planes.device)
        col.scatter_(1, tgt, planes[:, j].reshape(B, -1))
        cols.append(col[:, :n] + shift[:, j : j + 1])
    return fold_back(torch.stack(cols, dim=-1), box[:, None, :])


def init_cb_state(system: SystemState, spec: CBSpec, seed, n_moves: int = 1) -> CBState:
    """Initial sampler state; `seed` is an int or a torch.Generator on the
    state's device. All chains must share one box (the grid is static)."""
    box = system.box
    if not torch.equal(box, box[:1].expand_as(box)):
        raise ValueError("the checkerboard grid needs all chains to share one box")
    dev = system.position.device
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    B, _, d = system.position.shape
    shift = torch.zeros((B, d), dtype=system.position.dtype, device=dev)
    planes, idx, slot, overflow = rebin(system, spec, shift)
    zeros = torch.zeros((B, n_moves), dtype=torch.int64, device=dev)
    return CBState(
        system=system,
        generator=gen,
        shift=shift,
        planes=planes,
        idx=idx,
        slot=slot,
        attempted=zeros,
        accepted=zeros.clone(),
        overflow=overflow,
        skipped=torch.zeros(B, dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# Static move schedule
# ---------------------------------------------------------------------------


def _slot_schedule(pool, C: int, inner: int):
    """Assign each of the C*inner sub-move slots of a round a pool index:
    largest-remainder allocation (every move with p > 0 gets >= 1 slot),
    smoothly interleaved. A fixed composition of π-invariant kernels is
    π-invariant, and the mixture is exact over a round."""
    slots = C * inner
    n_moves = len(pool)
    if n_moves > slots:
        raise ValueError(
            f"move pool has {n_moves} moves but a round only has {slots} "
            f"sub-move slots; raise `inner`"
        )
    p = np.asarray([m.probability for m in pool], np.float64)
    p = p / p.sum()
    counts = np.floor(p * slots).astype(int)
    rem = slots - int(counts.sum())
    order = np.argsort(-(p * slots - counts))
    for k in range(rem):
        counts[order[k % n_moves]] += 1
    while (counts == 0).any():  # every move fires at least once per round
        counts[int(np.argmin(counts))] += 1
        counts[int(np.argmax(counts))] -= 1
    sched, used = [], np.zeros(n_moves)
    for t in range(slots):
        m = int(np.argmax(counts * (t + 1) / slots - used))
        sched.append(m)
        used[m] += 1
    return np.asarray(sched, int).reshape(C, inner)


# ---------------------------------------------------------------------------
# Grid pieces of a colour substep
# ---------------------------------------------------------------------------


def colours(d: int):
    """The static colour cycle: parity bits of the active sublattice."""
    return list(itertools.product((0, 1), repeat=d))


def pad_grid(planes, spec: CBSpec, box):
    """Wrap-pad the plane grid by one cell per dimension, with the halo faces
    of plane j along dimension j shifted by -/+ L_j (image-corrected), so
    that distances inside a substep are plain differences."""
    B, NP = planes.shape[:2]
    d = spec.d
    grid = planes.reshape((B, NP) + spec.ncells + (spec.cap,))
    for k in range(d):
        ax = 2 + k
        grid = torch.cat([grid.narrow(ax, -1 + grid.shape[ax], 1), grid, grid.narrow(ax, 0, 1)], dim=ax)
    for j in range(d):
        lo = (slice(None), j) + (slice(None),) * j + (0,)
        hi = (slice(None), j) + (slice(None),) * j + (spec.ncells[j] + 1,)
        corr = box[:, j].reshape((B,) + (1,) * d)
        grid[lo] = grid[lo] + (-corr)
        grid[hi] = grid[hi] + corr
    return grid


def _colour_slices(spec: CBSpec, c, offset):
    """Static strided slices of the padded grid: the active cells of colour
    `c`, shifted by `offset` cells."""
    return tuple(
        slice(c[k] + offset[k] + 1, c[k] + offset[k] + 2 * spec.active_dims[k], 2)
        for k in range(spec.d)
    )


def _neighbour_offsets(d: int):
    return [t for t in itertools.product((-1, 0, 1), repeat=d) if any(t)]


def extract_colour(padded, spec: CBSpec, c):
    """The kernel's packed lanes for colour `c`: packed_pos [B, d, A, LP] and
    packed_sp [B, A, LP], centre cell first, then the 3^d - 1 neighbours."""
    B, NP = padded.shape[:2]
    d, A = spec.d, spec.n_active
    blocks = [
        padded[(slice(None), slice(None)) + _colour_slices(spec, c, t)].reshape(
            B, NP, A, spec.cap
        )
        for t in [(0,) * d] + _neighbour_offsets(d)
    ]
    packed = torch.cat(blocks, dim=-1)
    return packed[:, :d].contiguous(), packed[:, d].contiguous()


def cell_bounds(spec: CBSpec, box_row, c):
    """lo, hi [d, A] of colour `c`'s active cells in the shifted frame
    (one box shared by all chains)."""
    grids = np.meshgrid(*[2 * np.arange(a) for a in spec.active_dims], indexing="ij")
    coords = np.stack([g.reshape(-1) for g in grids], axis=-1) + np.asarray(c)  # [A, d]
    dt = box_row.dtype
    side = box_row / torch.tensor(spec.ncells, dtype=dt, device=box_row.device)
    lo = torch.tensor(coords.T, dtype=dt, device=box_row.device) * side[:, None]
    return lo.contiguous(), (lo + side[:, None]).contiguous()


def write_back(padded, spec: CBSpec, c, centre, box):
    """Write the substep's centre positions into the grid and refresh one
    halo face per dimension (sequential face copies also carry the corners),
    image-corrected."""
    B = padded.shape[0]
    d = spec.d
    csl = _colour_slices(spec, c, (0,) * d)
    padded[(slice(None), slice(0, d)) + csl] = centre.reshape(
        (B, d) + spec.active_dims + (spec.cap,)
    )
    for k in range(d):
        nc_k = spec.ncells[k]
        if c[k] == 0:  # actives include grid coord 0: refresh the right halo
            src_i, dst_i, sign = 1, nc_k + 1, 1.0
        else:  # actives include grid coord nc-1: refresh the left halo
            src_i, dst_i, sign = nc_k, 0, -1.0
        pre = (slice(None), slice(0, d)) + (slice(None),) * k
        src = padded[pre + (src_i,)].clone()
        corr = box[:, k].reshape((B,) + (1,) * (src.dim() - 2))
        src[:, k] = src[:, k] + (corr if sign > 0 else -corr)
        padded[pre + (dst_i,)] = src


# ---------------------------------------------------------------------------
# The hyper-sweep
# ---------------------------------------------------------------------------


def _check_pool(pool):
    for mv in pool:
        if mv.action == "displacement" and mv.policy == "gaussian":
            continue
        if mv.action == "displacement":
            raise unported("SmartGaussian displacement on the checkerboard", 6)
        if mv.action == "swap":
            raise unported("DiscreteSwap moves on the checkerboard", 6)
        raise unported("MoleculeFlip moves (molecular systems)", 7)


def build_hyper_sweep_fn(
    spec: CBSpec,
    table: PairTable,
    n: int,
    sweepstep: Optional[int] = None,
    inner: int = 4,
    sweeps: int = 1,
    pool=None,
):
    """Returns `hyper_sweep(cb, pool_params, *, shift=None, up=None,
    ua=None, dl=None) -> CBState`: one rebin under a new grid shift, then
    `sweeps` hyper-sweeps of ~sweepstep (default n) attempted moves each,
    then one unbin of the positions.

    A hyper-sweep is `rounds` rounds of the 2^d colour substeps with
    A * inner sub-moves each. `pool` is a tuple of Gaussian displacement
    Moves; `pool_params` its parameter dicts (moves.base.init_pool_params).

    The randomness can be injected so that a test can give this port and the
    JAX package the same numbers: `shift` [B, d] (in units of the box),
    `up`/`ua` [B, R, C, inner, A] uniforms and `dl` [B, R, C, inner, d, A]
    standard normals, with R = sweeps * rounds and C = 2^d. Otherwise they
    are drawn from `cb.generator`, one round at a time.
    """
    from .base import displacement

    d = spec.d
    A = spec.n_active
    inner = max(1, int(inner))
    sweeps = max(1, int(sweeps))
    C = 2**d
    cols = colours(d)
    rounds = max(1, -(-int(sweepstep or n) // (A * inner * C)))
    R = sweeps * rounds
    pool = tuple(pool) if pool is not None else (displacement(1.0),)
    _check_pool(pool)
    n_moves = len(pool)
    schedule = _slot_schedule(pool, C, inner)
    # sub-move slots of each move within a colour, for the counters
    slots_of = [
        [[i for i in range(inner) if int(schedule[ci][i]) == m] for m in range(n_moves)]
        for ci in range(C)
    ]

    def hyper_sweep(cb: CBState, pool_params, *, shift=None, up=None, ua=None, dl=None):
        system = cb.system
        B = system.n_chains
        dt = system.position.dtype
        dev = system.position.device
        gen = cb.generator
        box = system.box
        tab = pack_table(table, dt).to(dev)
        injected = [x is not None for x in (up, ua, dl)]
        if any(injected) and not all(injected):
            raise ValueError("inject up, ua and dl together")
        if shift is None:
            shift = torch.rand((B, d), generator=gen, dtype=dt, device=dev)
        shift = shift * box
        planes0, idx, slot, ovf = rebin(system, spec, shift)
        padded = pad_grid(planes0, spec, box)

        sigmas = torch.stack([p["sigma"] for p in pool_params]).to(dev, dt)
        sigma_slot = sigmas[torch.as_tensor(schedule, device=dev)]  # [C, inner]
        neg_t = -system.temperature[:, None, None, None]
        bounds = [cell_bounds(spec, box[0], c) for c in cols]
        energy = system.energy.clone()
        att = torch.zeros((B, n_moves), dtype=torch.int64, device=dev)
        acc = torch.zeros((B, n_moves), dtype=torch.int64, device=dev)

        for r in range(R):
            if up is not None:
                up_r, ua_r, dl_r = up[:, r], ua[:, r], dl[:, r]
            else:
                shape = (B, C, inner, A)
                up_r = torch.rand(shape, generator=gen, dtype=dt, device=dev) * (1.0 - 1e-7)
                ua_r = torch.clamp_min(
                    torch.rand(shape, generator=gen, dtype=dt, device=dev),
                    torch.finfo(dt).tiny,
                )
                dl_r = torch.randn((B, C, inner, d, A), generator=gen, dtype=dt, device=dev)
            # fold sigma and the temperature into the draws: the kernel
            # compares ΔE with thr = -T log(u) and moves by dl * sigma
            thr_r = neg_t * torch.log(ua_r)
            dl_r = dl_r * sigma_slot[None, :, :, None, None]
            for ci, c in enumerate(cols):
                packed_pos, packed_sp = extract_colour(padded, spec, c)
                lo, hi = bounds[ci]
                centre, booked, acc_k = disp_substep(
                    packed_pos, packed_sp,
                    up_r[:, ci].contiguous(), dl_r[:, ci].contiguous(),
                    thr_r[:, ci].contiguous(), lo, hi, tab,
                )
                write_back(padded, spec, c, centre, box)
                energy = energy + torch.sum(booked.to(energy.dtype), dim=-1)
                occupied = torch.sum(
                    torch.any(packed_sp[..., : spec.cap] >= 0, dim=-1), dim=-1
                )  # [B] occupied active cells
                for m, slots_m in enumerate(slots_of[ci]):
                    if slots_m:
                        att[:, m] += occupied * len(slots_m)
                        acc[:, m] += torch.sum(acc_k[..., slots_m], dim=(1, 2))

        interior = (slice(None), slice(None)) + (slice(1, -1),) * d
        planes = padded[interior].reshape(planes0.shape)
        position = unbin_positions(planes, idx, n, shift, box)
        # skip-on-overflow: a block whose shift overflowed a bucket is the
        # identity (its validity is invariant under the block's own moves,
        # so apply-if-valid-else-identity stays π-reversible)
        ok = ~ovf
        ok2 = ok[:, None]
        ok4 = ok[:, None, None, None]
        system = system.replace(
            position=torch.where(ok[:, None, None], position, system.position),
            energy=torch.where(ok, energy, system.energy),
        )
        return cb.replace(
            system=system,
            shift=torch.where(ok2, shift, cb.shift),
            planes=torch.where(ok4, planes, cb.planes),
            idx=torch.where(ok[:, None, None], idx, cb.idx),
            slot=torch.where(ok2, slot, cb.slot),
            attempted=cb.attempted + torch.where(ok2, att, torch.zeros_like(att)),
            accepted=cb.accepted + torch.where(ok2, acc, torch.zeros_like(acc)),
            overflow=cb.overflow | ovf,
            skipped=cb.skipped + ovf.long(),
        )

    return hyper_sweep

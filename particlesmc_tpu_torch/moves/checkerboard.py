"""Checkerboard hyper-sweep (counterpart of particlesmc_tpu/moves/checkerboard.py).

Domain-decomposition Metropolis: particles are binned into a grid of cells
of side >= the interaction range (an even count per dimension) under a
random origin shift drawn per rebin block. A colour substep activates one of
the 2^d checkerboard sublattices; active cells are at least one cell apart,
so one move per active cell is independent of every other. Each active cell
runs `inner` sequential sub-moves against its own lanes and the 3^d - 1
neighbour cells, which stay static for the substep. The colours cycle in a
fixed order; the per-block shift restores ergodicity across cell boundaries.
A block whose binning overflows a bucket is the identity (skip-on-overflow),
which keeps the chain unbiased. With `trim_k` each substep first compacts
the neighbour lanes to those within reach of their active cell
(ColourSubsteps), and the sub-moves, the kernel's too, read only those.

Moves (a static per-slot schedule realises the pool's mixture):
- Displacement/SimpleGaussian: uniform pick in the cell, Gaussian proposal,
  rejection of a proposal that leaves the cell, Metropolis accept.
- Displacement/SmartGaussian (atomic): force-bias drift, clamped, with the
  exact Metropolis-Hastings asymmetry correction.
- DiscreteSwap/DoubleUniform (atomic): one particle of each species picked
  uniformly within the cell, labels exchanged; the cell's composition is
  kept, so the proposal is symmetric.
- DiscreteSwap/EnergyBias (atomic): each partner picked by a masked softmax
  of theta times its local energy, with the reverse density evaluated in the
  post-swap configuration.
- MoleculeFlip (molecular): a site i uniform in the cell and a partner site
  j uniform among the other members of i's molecule, rejected unless j is in
  the same cell and the species differ.

Layout: plane payload [B, NP, cells, cap] (shifted-frame positions, species
as floats with -1 for empty; molecular systems add particle id, bond-partner
ids, molecule start and molecule length), kept in a wrap-padded grid whose
halo faces are image-corrected so that every in-substep distance is a plain
coordinate difference. The in-cell test is [lo, hi) of the active cell.

The kernel: on an atomic system every maximal run of consecutive
SimpleGaussian slots of a colour is one launch of the CUDA kernel of
moves/cb_cuda.py, so an all-Gaussian pool is one launch per colour. The
other sub-moves are plain PyTorch on the batched tensors, as in the JAX
package they are XLA only. A molecular pool's Gaussian slots do not go
through the kernel: it computes the atomic ΔE only, without bond exclusions
or bond terms, and the reference keeps its kernel off for molecular systems
as well. The binning, neighbour extraction, halo refresh and unbin are plain
PyTorch.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..core.geometry import fold_back
from ..core.state import ChainBlock, SystemState, draw_batch, own_rows, shared_box
from ..models.potentials import (
    PAIR_FIELDS,
    bond_potential,
    pair_fields_needed,
    pair_potential,
    pair_virial,
)
from ..models.tables import BOND_FIELDS, PairTable, _Params, gather_pair, interaction_range, kinds_present
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
    bucket capacity over the mean occupancy; molecular systems take ~4 and
    rcut = tables.interaction_range (whole molecules pack into single cells,
    and a bond can reach past the pair cutoff)."""
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
    `chains` is a chain shard's place in the global batch (None unsharded):
    its draws are made at the global shape and cut to its rows.
    """

    system: SystemState
    generator: torch.Generator
    shift: torch.Tensor  # [B, d] grid origin offset
    planes: torch.Tensor  # [B, NP, cells, cap] shifted positions, species (+ molecular planes)
    idx: torch.Tensor  # [B, cells, cap] particle ids, -1 padded
    slot: torch.Tensor  # [B, n] flat payload slot of each particle
    attempted: torch.Tensor  # [B, n_moves]
    accepted: torch.Tensor  # [B, n_moves]
    overflow: torch.Tensor  # [B] sticky: some block was skipped
    skipped: torch.Tensor  # [B] count of skipped rebin blocks
    chains: Optional[ChainBlock] = None

    def replace(self, **kw) -> "CBState":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Binning. Payload positions are in the shifted frame x' = fold(x - shift):
# cell c spans [c*L/nc, (c+1)*L/nc) per dimension and no cell straddles the
# box boundary.
# ---------------------------------------------------------------------------


def _mol_columns(system: SystemState):
    """Per-particle molecular payload columns [B, 3 + maxb, n] as floats,
    -1 padded: particle id, the bond-partner ids, molecule start id and
    molecule length. They ride in the plane payload so that a sub-move finds
    a bonded partner by id inside the extracted 3^d blocks (a partner is
    always within one interaction range, hence in the block). Molecule ids
    are consecutive runs, so start and length come from run-boundary
    cummax/cummin. Ids are exact in float32 up to 2^24 particles. None for
    an atomic system."""
    if system.bonds is None:
        return None
    B, n = system.species.shape
    dev = system.species.device
    iota = torch.arange(n, device=dev).expand(B, n)
    mol = system.molecule
    diff = mol[:, 1:] != mol[:, :-1]
    one = torch.ones((B, 1), dtype=torch.bool, device=dev)
    start_pp = torch.cummax(torch.where(torch.cat([one, diff], 1), iota, 0), dim=1).values
    end_at = torch.where(torch.cat([diff, one], 1), iota, n - 1)
    end_pp = torch.flip(torch.cummin(torch.flip(end_at, [1]), dim=1).values, [1])
    cols = [iota, *system.bonds.unbind(-1), start_pp, end_pp - start_pp + 1]
    return torch.stack(cols, dim=1).to(system.position.dtype)


def _host_copy(data, device, dtype=None):
    """`data` from host memory as a tensor on `device`: the copy waits for
    the device's queue, so the block's start waits here (the `cb.host_copy`
    phase, which times the wait outside the profiler too)."""
    with tracing.phase("cb.host_copy"):
        return torch.tensor(data, dtype=dtype, device=device)


def rebin(system: SystemState, spec: CBSpec, shift):
    """Bin every chain: returns planes [B, NP, cells, cap], idx
    [B, cells, cap], slot [B, n] and overflow [B].

    A stable sort by cell key orders the particles; each cell's run is then
    cut into its `cap` lanes (searchsorted gives the run bounds)."""
    B, n, d = system.position.shape
    dt = system.position.dtype
    dev = system.position.device
    box = system.box[:, None, :]
    xs = fold_back(system.position - shift[:, None, :], box)
    nc = _host_copy(spec.ncells, dev)
    cvec = torch.clamp(torch.floor(xs / box * nc.to(dt)).long(), torch.zeros_like(nc), nc - 1)
    cell = cvec[..., 0]
    for k in range(1, d):
        cell = cell * spec.ncells[k] + cvec[..., k]
    sorted_cell, perm = torch.sort(cell, dim=-1, stable=True)
    comps = [xs.transpose(1, 2), system.species.to(dt)[:, None, :]]
    mol_cols = _mol_columns(system)
    if mol_cols is not None:
        comps.append(mol_cols)
    comps = torch.cat(comps, dim=1)
    np_ = comps.shape[1]
    sorted_comps = torch.gather(comps, 2, perm[:, None, :].expand(B, np_, n))
    cells_iota = torch.arange(spec.total, device=dev).expand(B, spec.total).contiguous()
    first = torch.searchsorted(sorted_cell, cells_iota, side="left")
    nxt = torch.searchsorted(sorted_cell, cells_iota, side="right")

    p = first[..., None] + torch.arange(spec.cap, device=dev)  # [B, cells, cap]
    valid = p < nxt[..., None]
    pc = torch.clamp(p, max=n - 1).reshape(B, -1)
    fills = _host_copy([0.0] * d + [-1.0] * (np_ - d), dev, dt)[None, :, None, None]
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


def _unbin_planes(planes, idx, n: int):
    """Scatter payload planes [B, k, cells, cap] back to particle order
    [B, k, n] in one scatter; padding lanes go to a dropped column."""
    B, k = planes.shape[:2]
    flat_idx = idx.reshape(B, 1, -1)
    tgt = torch.where(flat_idx >= 0, flat_idx, n).expand(B, k, -1)
    cols = torch.zeros((B, k, n + 1), dtype=planes.dtype, device=planes.device)
    cols.scatter_(2, tgt, planes.reshape(B, k, -1))
    return cols[..., :n]


def unbin_positions(planes, idx, n: int, shift, box):
    """Scatter payload positions back into global [B, N, d] positions."""
    d = box.shape[-1]
    xs = _unbin_planes(planes[:, :d], idx, n) + shift[:, :, None]
    return fold_back(xs.transpose(1, 2).contiguous(), box[:, None, :])


def init_cb_state(system: SystemState, spec: CBSpec, seed, n_moves: int = 1) -> CBState:
    """Initial sampler state; `seed` is an int or a torch.Generator on the
    state's device. All chains must share one box (the grid is static):
    boxes allclose to chain 0's, which sets the cell bounds."""
    if not shared_box(system.box):
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


def _is_gaussian(mv) -> bool:
    return mv.action == "displacement" and mv.policy == "gaussian"


def schedule_segments(schedule_row, pool, kernel: bool):
    """Cut one colour's slot schedule into segments (start, stop, on_kernel):
    with `kernel`, each maximal run of consecutive SimpleGaussian slots is
    one segment for the kernel; every other slot is a segment of its own."""
    segs = []
    k = 0
    inner = len(schedule_row)
    while k < inner:
        if kernel and _is_gaussian(pool[int(schedule_row[k])]):
            stop = k
            while stop < inner and _is_gaussian(pool[int(schedule_row[stop])]):
                stop += 1
            segs.append((k, stop, True))
            k = stop
        else:
            segs.append((k, k + 1, False))
            k += 1
    return segs


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
    """Every plane of colour `c`'s active cells and their 3^d - 1 neighbours,
    centre cell first: the kernel's packed_pos [B, d, A, LP] and packed_sp
    [B, A, LP], and the molecular planes [B, NP - d - 1, A, LP] (None for an
    atomic grid)."""
    B, NP = padded.shape[:2]
    d, A = spec.d, spec.n_active
    blocks = [
        padded[(slice(None), slice(None)) + _colour_slices(spec, c, t)].reshape(
            B, NP, A, spec.cap
        )
        for t in [(0,) * d] + _neighbour_offsets(d)
    ]
    packed = torch.cat(blocks, dim=-1)
    aux = packed[:, d + 1 :] if NP > d + 1 else None
    return packed[:, :d].contiguous(), packed[:, d].contiguous(), aux


def cell_bounds(spec: CBSpec, box_row, c):
    """lo, hi [d, A] of colour `c`'s active cells in the shifted frame
    (one box shared by all chains; the hyper-sweep passes chain 0's, where
    the JAX package takes each chain's own)."""
    grids = np.meshgrid(*[2 * np.arange(a) for a in spec.active_dims], indexing="ij")
    coords = np.stack([g.reshape(-1) for g in grids], axis=-1) + np.asarray(c)  # [A, d]
    dt = box_row.dtype
    side = box_row / _host_copy(spec.ncells, box_row.device, dt)
    lo = _host_copy(coords.T, box_row.device, dt) * side[:, None]
    return lo.contiguous(), (lo + side[:, None]).contiguous()


def write_back(padded, spec: CBSpec, c, centre, box, centre_sp=None, first_dim: int = 0):
    """Write the substep's centre positions (and species, when the pool
    changes them) into the grid and refresh one halo face per dimension of
    those planes (sequential face copies also carry the corners),
    image-corrected. The molecular planes never change. A slab of the
    spatial backend refreshes the dimensions from `first_dim` = 1 on; its
    dimension-0 halos come from the neighbouring slabs."""
    B = padded.shape[0]
    d = spec.d
    csl = _colour_slices(spec, c, (0,) * d)
    shape = spec.active_dims + (spec.cap,)
    padded[(slice(None), slice(0, d)) + csl] = centre.reshape((B, d) + shape)
    n_live = d
    if centre_sp is not None:
        padded[(slice(None), d) + csl] = centre_sp.reshape((B,) + shape)
        n_live = d + 1
    for k in range(first_dim, d):
        nc_k = spec.ncells[k]
        if c[k] == 0:  # actives include grid coord 0: refresh the right halo
            src_i, dst_i, sign = 1, nc_k + 1, 1.0
        else:  # actives include grid coord nc-1: refresh the left halo
            src_i, dst_i, sign = nc_k, 0, -1.0
        pre = (slice(None), slice(0, n_live)) + (slice(None),) * k
        src = padded[pre + (src_i,)].clone()
        corr = box[:, k].reshape((B,) + (1,) * (src.dim() - 2))
        src[:, k] = src[:, k] + (corr if sign > 0 else -corr)
        padded[pre + (dst_i,)] = src


# ---------------------------------------------------------------------------
# Sub-moves other than the kernel's, on batched tensors: centre positions
# [B, d, A, cap] and species [B, A, cap], the static neighbour lanes
# [B, d, A, L] and [B, A, L], draws and decisions [B, A]. Pair parameters are
# gathered from the packed [9, S, S] table of moves/cb_cuda.py::pack_table;
# each sum runs over the centre lanes, then over the neighbour lanes.
# ---------------------------------------------------------------------------

_INT_FIELDS = ("kind", "ipl_n")
# elements of one [B, A, cap, LP] member-energy buffer (EnergyBias); the
# evaluation runs in chunks of chains within it
_MEMBER_BUDGET = 1 << 22
# the smart move's drift is clamped to this many sigmas per component
_DRIFT_CLIP_SIGMAS = 2.0


class _Tables:
    """The pair table of one hyper-sweep call in the state's dtype and on its
    device: packed for the kernel, flat per field for gathers, and the bond
    fields for molecular systems."""

    def __init__(self, table: PairTable, kinds, dt, dev, molecular: bool):
        self.packed = pack_table(table, dt).to(dev)
        self.S = table.n_species
        self.kinds = kinds
        self.fields = pair_fields_needed(kinds)
        self.flat = self.packed.reshape(len(PAIR_FIELDS), -1)
        self.bond = None
        if molecular:
            t = table.astype(dt)
            self.bond = dataclasses.replace(
                t, **{f.name: getattr(t, f.name).to(dev) for f in dataclasses.fields(t)}
            )

    def pair(self, sa, sb):
        """Parameters of the species pairs (sa, sb), long tensors or ints."""
        idx = sa * self.S + sb
        out = {}
        for f in self.fields:
            v = self.flat[PAIR_FIELDS.index(f)][idx]
            out[f] = v.to(torch.int32) if f in _INT_FIELDS else v
        return _Params(**out)

    def u(self, r2, p):
        return pair_potential(r2, p, self.kinds)


def _species_index(sp):
    """Float species (-1 empty) as table indices; an empty lane reads row 0."""
    return torch.clamp_min(sp, 0).long()


def _sel(pick, plane):
    """The picked lane of `plane` [..., A, cap] under a one-hot `pick`
    [B, A, cap] (broadcast over a d axis): [..., A]."""
    if plane.dim() == pick.dim() + 1:
        pick = pick[:, None]
    return torch.sum(torch.where(pick, plane, torch.zeros_like(plane)), dim=-1)


def _r2(pos_nb, x):
    """Squared plain differences [B, A, L] of lanes pos_nb [B, d, A, L] from
    x [B, d, A], summed in dimension order."""
    r2 = torch.zeros_like(pos_nb[:, 0])
    for j in range(pos_nb.shape[1]):
        dx = pos_nb[:, j] - x[:, j, :, None]
        r2 = r2 + dx * dx
    return r2


def _masked_sum(valid, v):
    return torch.sum(torch.where(valid, v, torch.zeros_like(v)), dim=-1)


def _in_cell(x, lo, hi):
    """x [B, d, A] inside [lo, hi) of its active cell."""
    return ((x >= lo) & (x < hi)).all(dim=1)


def _book(accept, de):
    return torch.where(accept & torch.isfinite(de), de, torch.zeros_like(de))


def _disp_submove_smart(
    tabs, centre_pos, centre_sp, pos_o, sp_o, pick, xi, sigma, lo, hi, occupied,
    log_ua, temperature,
):
    """One force-bias ("smart MC") displacement sub-move.

    Proposal: delta = D(x_old) + sigma xi with drift D(x) = clamp(sigma^2 /
    (2T) F(x), +-_DRIFT_CLIP_SIGMAS sigma) per component, F the force on the
    mover from every valid lane. Acceptance: log a = -dE/T + [|delta -
    D(x_old)|^2 - |delta + D(x_new)|^2] / (2 sigma^2), the exact asymmetry
    correction with the reverse drift at the proposed position. A proposal
    that leaves the cell is rejected; both q factors are the unconstrained
    Gaussians, so the in-cell truncation keeps detailed balance.
    Returns (centre_pos', booked [B, A], accept [B, A])."""
    t = temperature[:, None]
    x_a = _sel(pick, centre_pos)
    s_a = _species_index(_sel(pick, centre_sp))[..., None]
    groups = (
        (centre_pos, centre_sp, (centre_sp >= 0) & ~pick),
        (pos_o, sp_o, sp_o >= 0),
    )

    def energy_and_force(x):
        e = torch.zeros_like(x[:, 0])
        f = torch.zeros_like(x)
        for pos_nb, sp_nb, valid in groups:
            p = tabs.pair(s_a, _species_index(sp_nb))
            dx = pos_nb - x[..., None]
            r2 = _r2(pos_nb, x)
            u = tabs.u(r2, p)
            w = pair_virial(r2, p, tabs.kinds)
            g = -w / torch.clamp_min(r2, 1e-12)  # F_j = g dx_j
            e = e + _masked_sum(valid, u)
            f = f + _masked_sum(valid[:, None], g[:, None] * dx)
        return e, f

    sig2_2t = (sigma * sigma / (2.0 * temperature))[:, None, None]
    clip = _DRIFT_CLIP_SIGMAS * sigma

    def drift(f):
        return torch.clamp(sig2_2t * f, -clip, clip)

    e_old, f_old = energy_and_force(x_a)
    d_old = drift(f_old)
    delta = d_old + sigma * xi
    x_new = x_a + delta
    in_cell = occupied & _in_cell(x_new, lo, hi)
    e_new, f_new = energy_and_force(x_new)
    d_new = drift(f_new)
    de = e_new - e_old
    lq = torch.zeros_like(de)
    for j in range(x_a.shape[1]):
        fwd = delta[:, j] - d_old[:, j]  # = sigma xi_j
        rev = delta[:, j] + d_new[:, j]
        lq = lq + (fwd * fwd - rev * rev)
    log_alpha = -de / t + lq / (2.0 * sigma * sigma)
    log_alpha = torch.where(torch.isnan(log_alpha), torch.full_like(log_alpha, -math.inf), log_alpha)
    accept = (log_ua < log_alpha) & in_cell
    moved = (pick & accept[..., None])[:, None]
    centre_pos = torch.where(moved, x_new[..., None], centre_pos)
    return centre_pos, _book(accept, de), accept


def _swap_pair_de(tabs, s1, s2, centre_pos, centre_sp, pos_o, sp_o, pick_i, pick_j):
    """ΔE of swapping the species of the picked pair (i: s1 -> s2 at x_i,
    j: s2 -> s1 at x_j). Both sums exclude i and j: the mutual pair term
    cancels exactly by table symmetry. Returns de [B, A]."""
    x_i = _sel(pick_i, centre_pos)
    x_j = _sel(pick_j, centre_pos)
    de = torch.zeros_like(x_i[:, 0])
    for pos_nb, sp_nb, valid in (
        (centre_pos, centre_sp, (centre_sp >= 0) & ~pick_i & ~pick_j),
        (pos_o, sp_o, sp_o >= 0),
    ):
        nb = _species_index(sp_nb)
        p_a = tabs.pair(s1, nb)
        p_b = tabs.pair(s2, nb)
        r2i = _r2(pos_nb, x_i)
        r2j = _r2(pos_nb, x_j)
        du = tabs.u(r2i, p_b) - tabs.u(r2i, p_a) + tabs.u(r2j, p_a) - tabs.u(r2j, p_b)
        de = de + _masked_sum(valid, du)
    return de


def _apply_swap(centre_sp, pick_i, pick_j, accept, s1, s2):
    return torch.where(
        pick_i & accept[..., None],
        torch.full_like(centre_sp, float(s2)),
        torch.where(pick_j & accept[..., None], torch.full_like(centre_sp, float(s1)), centre_sp),
    )


def _swap_submove_atomic(
    tabs, s1, s2, centre_pos, centre_sp, pos_o, sp_o, up, up2, log_ua, temperature,
):
    """One in-cell DiscreteSwap/DoubleUniform sub-move: i uniform among the
    cell's s1 members (by `up`), j among its s2 members (by `up2`); a cell
    missing either species rejects. Returns (centre_sp', booked, accept)."""
    dt = centre_sp.dtype
    memb1 = centre_sp == float(s1)
    memb2 = centre_sp == float(s2)
    n1 = memb1.sum(dim=-1)
    n2 = memb2.sum(dim=-1)
    r1 = torch.floor(up * n1.to(dt)).long()
    r2 = torch.floor(up2 * n2.to(dt)).long()
    rank1 = torch.cumsum(memb1.long(), dim=-1) - 1
    rank2 = torch.cumsum(memb2.long(), dim=-1) - 1
    pick_i = memb1 & (rank1 == r1[..., None])
    pick_j = memb2 & (rank2 == r2[..., None])
    valid_sw = (n1 > 0) & (n2 > 0)
    de = _swap_pair_de(tabs, s1, s2, centre_pos, centre_sp, pos_o, sp_o, pick_i, pick_j)
    accept = valid_sw & (log_ua < -de / temperature[:, None])
    return _apply_swap(centre_sp, pick_i, pick_j, accept, s1, s2), _book(accept, de), accept


def _cell_member_energies(tabs, centre_pos, centre_sp, pos_o, sp_o):
    """Local energies E [B, A, cap] of every centre lane against the whole
    3^d neighbourhood (own cell without itself, then the static neighbour
    lanes): the input of the EnergyBias softmax. The [B, A, cap, LP] pair
    buffers are evaluated in chunks of chains (_MEMBER_BUDGET)."""
    B, A, cap = centre_sp.shape
    L = pos_o.shape[-1]
    chunk = max(1, _MEMBER_BUDGET // max(1, A * cap * (cap + L)))
    not_self = ~torch.eye(cap, dtype=torch.bool, device=centre_sp.device)
    out = []
    for b0 in range(0, B, chunk):
        cp, cs = centre_pos[b0 : b0 + chunk], centre_sp[b0 : b0 + chunk]
        po, so = pos_o[b0 : b0 + chunk], sp_o[b0 : b0 + chunk]
        valid_c = cs >= 0
        sa = _species_index(cs)
        r2cc = torch.zeros(cs.shape + (cap,), dtype=cp.dtype, device=cp.device)
        r2co = torch.zeros(cs.shape + (L,), dtype=cp.dtype, device=cp.device)
        for j in range(cp.shape[1]):
            dx = cp[:, j, :, :, None] - cp[:, j, :, None, :]
            r2cc = r2cc + dx * dx
            dx = po[:, j, :, None, :] - cp[:, j, :, :, None]
            r2co = r2co + dx * dx
        ucc = tabs.u(r2cc, tabs.pair(sa[..., :, None], sa[..., None, :]))
        mcc = valid_c[..., :, None] & valid_c[..., None, :] & not_self
        e = _masked_sum(mcc, ucc)
        uco = tabs.u(r2co, tabs.pair(sa[..., :, None], _species_index(so)[..., None, :]))
        mco = valid_c[..., :, None] & (so >= 0)[..., None, :]
        out.append(e + _masked_sum(mco, uco))
    return torch.cat(out, dim=0)


def _softmax_pick(logits, memb, u):
    """Inverse-CDF categorical over the masked softmax of `logits`
    [..., cap] restricted to `memb`, driven by one uniform u [...] per cell.
    Returns (one-hot pick, log-prob of the picked lane). A cell with no
    member returns an all-false pick (the caller rejects it)."""
    neg = torch.full_like(logits, -math.inf)
    lv = torch.where(memb, logits, neg)
    m = torch.amax(lv, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(memb, torch.exp(lv - m), torch.zeros_like(logits))
    tot = torch.sum(w, dim=-1, keepdim=True)
    cum = torch.cumsum(w, dim=-1)
    thr = u[..., None] * tot  # u in [0, 1): thr < tot, so exactly one lane hits
    pick = memb & (cum > thr) & ((cum - w) <= thr)
    # ties on equal cumsum plateaus (w == 0 runs) resolve to the first lane
    pick = pick & (torch.cumsum(pick.long(), dim=-1) == 1)
    tiny = torch.finfo(logits.dtype).tiny
    logp = torch.sum(torch.where(pick, lv, torch.zeros_like(lv)), dim=-1) - (
        m[..., 0] + torch.log(torch.clamp_min(tot[..., 0], tiny))
    )
    return pick, logp


def _logsumexp_masked(lv):
    tiny = torch.finfo(lv.dtype).tiny
    m = torch.amax(lv, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m[..., 0] + torch.log(torch.clamp_min(torch.sum(torch.exp(lv - m), dim=-1), tiny))


def _swap_submove_energy_bias(
    tabs, s1, s2, centre_pos, centre_sp, pos_o, sp_o, th1, th2, up, up2, log_ua, temperature,
):
    """One in-cell DiscreteSwap/EnergyBias sub-move: i drawn from the cell's
    s1 members with probability ∝ exp(th1 E_i), j from its s2 members ∝
    exp(th2 E_j), E the members' local energies. The proposal is asymmetric;
    the reverse density is evaluated in the post-swap configuration (i now
    s2, j now s1) over the same populations, so Metropolis-Hastings is
    exact. A NaN log-acceptance (for instance th = 0 against an infinite
    energy) rejects. Returns (centre_sp', booked, accept)."""
    memb1 = centre_sp == float(s1)
    memb2 = centre_sp == float(s2)
    valid_sw = memb1.any(dim=-1) & memb2.any(dim=-1)
    e_pre = _cell_member_energies(tabs, centre_pos, centre_sp, pos_o, sp_o)
    pick_i, lp_i = _softmax_pick(th1 * e_pre, memb1, up)
    pick_j, lp_j = _softmax_pick(th2 * e_pre, memb2, up2)
    log_q_fwd = lp_i + lp_j
    de = _swap_pair_de(tabs, s1, s2, centre_pos, centre_sp, pos_o, sp_o, pick_i, pick_j)

    # reverse density in the post-swap configuration
    centre_sp2 = _apply_swap(centre_sp, pick_i, pick_j, torch.ones_like(valid_sw), s1, s2)
    e_post = _cell_member_energies(tabs, centre_pos, centre_sp2, pos_o, sp_o)
    neg = torch.full_like(e_post, -math.inf)
    l1 = torch.where(centre_sp2 == float(s1), th1 * e_post, neg)
    l2 = torch.where(centre_sp2 == float(s2), th2 * e_post, neg)
    zero = torch.zeros_like(e_post)
    lp_rev_j = torch.sum(torch.where(pick_j, th1 * e_post, zero), dim=-1) - _logsumexp_masked(l1)
    lp_rev_i = torch.sum(torch.where(pick_i, th2 * e_post, zero), dim=-1) - _logsumexp_masked(l2)
    log_q_rev = lp_rev_j + lp_rev_i

    log_alpha = -de / temperature[:, None] + log_q_rev - log_q_fwd
    log_alpha = torch.where(torch.isnan(log_alpha), torch.full_like(log_alpha, -math.inf), log_alpha)
    accept = valid_sw & (log_ua < log_alpha)
    return _apply_swap(centre_sp, pick_i, pick_j, accept, s1, s2), _book(accept, de), accept


class _Molecular:
    """The bond bookkeeping of one colour substep on a molecular grid. The
    id, bond-partner and molecule-layout planes never change in a substep;
    a bonded partner is found by id inside the extracted blocks."""

    def __init__(self, tabs, aux, cap, max_bonds):
        self.tabs = tabs
        self.cap = cap
        ids = aux[:, 0]
        self.centre_id, self.other_id = ids[..., :cap], ids[..., cap:]
        self.centre_bonds = [aux[:, 1 + b, :, :cap] for b in range(max_bonds)]
        self.centre_ms = aux[:, 1 + max_bonds, :, :cap]
        self.centre_ml = aux[:, 2 + max_bonds, :, :cap]

    @staticmethod
    def bond_excl(ids_nb, partners):
        """Lanes that are bonded partners of the mover (left out of the
        non-bonded sum)."""
        m = torch.zeros(ids_nb.shape, dtype=torch.bool, device=ids_nb.device)
        for pb in partners:
            m = m | ((ids_nb == pb[..., None]) & (pb[..., None] >= 0))
        return m

    def find_by_id(self, pid, centre_pos, centre_sp, pos_o, sp_o):
        """Position [B, d, A], species and found flag [B, A] of particle
        `pid` [B, A] in the blocks (halos are image-corrected, so the
        position is directly usable in plain differences)."""
        mc = (self.centre_id == pid[..., None]) & (pid[..., None] >= 0)
        mo = (self.other_id == pid[..., None]) & (pid[..., None] >= 0)
        xp = _sel(mc, centre_pos) + _sel(mo, pos_o)
        sp_p = _sel(mc, centre_sp) + _sel(mo, sp_o)
        return xp, sp_p, mc.any(dim=-1) | mo.any(dim=-1)

    def bond_delta(self, x_old, x_new, s_old, s_new, partners, skip_id, live):
        """Σ_b [u_bond(new) - u_bond(old)] over the mover's bond partners;
        +inf (a rejection) if a live partner is not in the blocks. `skip_id`
        leaves out the mutual bond of a flip pair (it cancels by table
        symmetry). Position and species may both change."""
        de_b = torch.zeros_like(s_old)
        for pb in partners:
            act = pb >= 0
            if skip_id is not None:
                act = act & (pb != skip_id)
            xp, sp_p, found = self.find_by_id(pb, *live)
            r2o = torch.zeros_like(s_old)
            r2n = torch.zeros_like(s_old)
            for j in range(x_old.shape[1]):
                dxo = xp[:, j] - x_old[:, j]
                dxn = xp[:, j] - x_new[:, j]
                r2o = r2o + dxo * dxo
                r2n = r2n + dxn * dxn
            tab = self.tabs.bond
            nb = _species_index(sp_p)
            po = gather_pair(tab, _species_index(s_old), nb, BOND_FIELDS)
            pn = gather_pair(tab, _species_index(s_new), nb, BOND_FIELDS)
            du = bond_potential(r2n, pn) - bond_potential(r2o, po)
            du = torch.where(found, du, torch.full_like(du, math.inf))
            de_b = de_b + torch.where(act, du, torch.zeros_like(du))
        return de_b

    def displacement(self, centre_pos, centre_sp, pos_o, sp_o, pick, delta, lo, hi, occupied,
                     log_ua, temperature):
        """One molecular Gaussian displacement sub-move: the non-bonded ΔE
        without the mover's bonded partners, plus the FENE + LJ bond delta.
        Returns (centre_pos', booked, accept)."""
        tabs = self.tabs
        x_a = _sel(pick, centre_pos)
        s_a = _sel(pick, centre_sp)
        x_new = x_a + delta
        in_cell = occupied & _in_cell(x_new, lo, hi)
        partners = [_sel(pick, b) for b in self.centre_bonds]
        sa = _species_index(s_a)[..., None]
        de = torch.zeros_like(s_a)
        for pos_nb, ids_nb, sp_nb, valid in (
            (centre_pos, self.centre_id, centre_sp, (centre_sp >= 0) & ~pick),
            (pos_o, self.other_id, sp_o, sp_o >= 0),
        ):
            valid = valid & ~self.bond_excl(ids_nb, partners)
            p = tabs.pair(sa, _species_index(sp_nb))
            du = tabs.u(_r2(pos_nb, x_new), p) - tabs.u(_r2(pos_nb, x_a), p)
            de = de + _masked_sum(valid, du)
        live = (centre_pos, centre_sp, pos_o, sp_o)
        de = de + self.bond_delta(x_a, x_new, s_a, s_a, partners, None, live)
        accept = (log_ua < -de / temperature[:, None]) & in_cell
        moved = (pick & accept[..., None])[:, None]
        centre_pos = torch.where(moved, x_new[..., None], centre_pos)
        return centre_pos, _book(accept, de), accept

    def flip(self, centre_pos, centre_sp, pos_o, sp_o, pick, up2, occupied, log_ua, temperature):
        """One cell-local MoleculeFlip sub-move: i is the picked lane; its
        partner site j is uniform over the other members of i's molecule
        (skipping i's own rank); a flip whose j is not in the same cell, or
        whose species agree, rejects. The selection is symmetric: the flip
        moves nothing. Returns (centre_sp', booked, accept)."""
        tabs = self.tabs
        dt = centre_sp.dtype
        x_i = _sel(pick, centre_pos)
        s_i = _sel(pick, centre_sp)
        id_i = _sel(pick, self.centre_id)
        ms, ml = _sel(pick, self.centre_ms), _sel(pick, self.centre_ml)
        partners_i = [_sel(pick, b) for b in self.centre_bonds]
        lm1 = torch.clamp_min(ml - 1.0, 1.0)
        off = torch.floor(up2 * lm1)
        off = off + (off >= (id_i - ms)).to(dt)
        pj = ms + off
        match_j = (self.centre_id == pj[..., None]) & occupied[..., None]
        found_j = match_j.any(dim=-1)
        x_j = _sel(match_j, centre_pos)
        s_j = _sel(match_j, centre_sp)
        partners_j = [_sel(match_j, b) for b in self.centre_bonds]
        valid_fl = occupied & (ml > 1.5) & found_j & (s_i != s_j)

        # species of i and j exchange, positions fixed; the mutual term
        # cancels, so ΔE = Δ_i + Δ_j, each without the pair and its own
        # bonded partners
        si = _species_index(s_i)[..., None]
        sj = _species_index(s_j)[..., None]
        de = torch.zeros_like(s_i)
        for pos_nb, ids_nb, sp_nb, valid in (
            (centre_pos, self.centre_id, centre_sp, (centre_sp >= 0) & ~pick & ~match_j),
            (pos_o, self.other_id, sp_o, sp_o >= 0),
        ):
            nb = _species_index(sp_nb)
            p_i = tabs.pair(si, nb)
            p_j = tabs.pair(sj, nb)
            excl_i = self.bond_excl(ids_nb, partners_i)
            excl_j = self.bond_excl(ids_nb, partners_j)
            r2i = _r2(pos_nb, x_i)
            r2j = _r2(pos_nb, x_j)
            du_i = tabs.u(r2i, p_j) - tabs.u(r2i, p_i)
            du_j = tabs.u(r2j, p_i) - tabs.u(r2j, p_j)
            de = de + _masked_sum(valid & ~excl_i, du_i)
            de = de + _masked_sum(valid & ~excl_j, du_j)
        live = (centre_pos, centre_sp, pos_o, sp_o)
        de = de + self.bond_delta(x_i, x_i, s_i, s_j, partners_i, pj, live)
        de = de + self.bond_delta(x_j, x_j, s_j, s_i, partners_j, id_i, live)
        accept = valid_fl & (log_ua < -de / temperature[:, None])
        centre_sp = torch.where(
            pick & accept[..., None],
            s_j[..., None].expand_as(centre_sp),
            torch.where(match_j & accept[..., None], s_i[..., None].expand_as(centre_sp), centre_sp),
        )
        return centre_sp, _book(accept, de), accept


# ---------------------------------------------------------------------------
# The hyper-sweep
# ---------------------------------------------------------------------------


# span (tracing.span) around each sub-move that is not the kernel's, by
# kind, and around the candidate compaction of a substep; counter
# (tracing.count) of those sub-moves' slots run, by kind
SUBMOVE_RANGE = "cb.submove."
SUBMOVE_CALLS = "cb.submove_calls."
TRIM_RANGE = "cb.trim"


def _rel_slots(rel, m):
    """(m, the move's slots in its segment, their count): a slice when the
    slots are contiguous, so that reading the counters copies no index."""
    if rel == list(range(rel[0], rel[-1] + 1)):
        return m, slice(rel[0], rel[-1] + 1), len(rel)
    return m, tuple(rel), len(rel)


def submove_kind(mv) -> str:
    """The name of a non-kernel sub-move's span: smart,
    molecular_displacement, double_uniform, energy_bias or flip."""
    if mv.action == "displacement":
        return "smart" if mv.policy == "smart" else "molecular_displacement"
    return mv.policy if mv.action == "swap" else "flip"


def check_pool(pool, molecular: bool):
    """Refuse a move the checkerboard backend does not run (as the JAX
    package does): SmartGaussian and swaps need an atomic system, flips a
    molecular one."""
    for mv in pool:
        ok = (
            (mv.action == "displacement" and (mv.policy != "smart" or not molecular))
            or (mv.action == "swap" and mv.policy in ("double_uniform", "energy_bias") and not molecular)
            or (mv.action == "flip" and molecular)
        )
        if not ok:
            raise ValueError(
                f"checkerboard backend does not support {mv.action}/{mv.policy}"
                + (" on molecular systems" if molecular else "")
                + " — use the sequential kernel (parallel_moves=false)"
            )


def auto_trim_k(spec: CBSpec, box, rcut: float, n: int, nsigma: float = 7.0) -> Optional[int]:
    """Lane capacity of the per-substep candidate compaction (`trim_k`).

    A lane of the 3^d - 1 static neighbour blocks can interact with a mover,
    which stays inside its active cell for the whole substep, only if its
    distance to the cell's cube is <= rcut: it lies in the cube dilated by
    rcut. The mean count there is density * (V_dilated - V_cell); `nsigma`
    Poisson standard deviations of headroom are added and the result is
    rounded up to a multiple of 128 lanes (the JAX package's sizing, kept
    as it is). Returns None when compaction cannot beat the uncompacted
    (3^d - 1) * cap lanes."""
    box = np.asarray(box, np.float64)
    side = box / np.asarray(spec.ncells, np.float64)
    v_cell = float(np.prod(side))
    d = spec.d
    if d == 2:
        s1, s2 = side
        v_dil = s1 * s2 + 2.0 * rcut * (s1 + s2) + math.pi * rcut**2
    elif d == 3:
        s1, s2, s3 = side
        v_dil = (
            s1 * s2 * s3
            + 2.0 * rcut * (s1 * s2 + s1 * s3 + s2 * s3)
            + math.pi * rcut**2 * (s1 + s2 + s3)
            + 4.0 / 3.0 * math.pi * rcut**3
        )
    else:
        return None
    density = n / float(np.prod(box))
    mean = density * (v_dil - v_cell)
    k = int(mean + nsigma * math.sqrt(max(mean, 1.0)) + 0.5)
    k = max(128, -(-k // 128) * 128)
    if k >= (3**d - 1) * spec.cap:
        return None
    return k


@dataclasses.dataclass
class _Context:
    """What one hyper-sweep call's sub-moves read besides the lanes and the
    draws: tables, per-move parameters and per-slot sigmas on the state's
    device."""

    tabs: _Tables
    sigmas: list
    thetas: list
    sigma_slot: Optional[torch.Tensor]
    neg_t: torch.Tensor
    temperature: torch.Tensor
    slot_iota: Optional[torch.Tensor]


class ColourSubsteps:
    """The static schedule of a hyper-sweep and the sub-moves of one colour
    substep on one grid: the whole grid (build_hyper_sweep_fn) or one slab of
    it (parallel/spatial.py).

    `trim_k` turns on the per-substep candidate compaction: after the lanes
    are extracted, the neighbour lanes within `trim_rcut` (default
    tables.interaction_range) of their active cell's cube move to the front
    in their original order and the first `trim_k` are kept, so that every
    sub-move of the substep, the kernel's too, reads cap + trim_k lanes. A
    dropped lane is beyond the cutoff of every position the mover can take
    in its cell (and beyond any bond's reach with the interaction range), so
    it adds nothing to any energy change; only the summation order changes.
    A chain with more than `trim_k` lanes in range for some active cell runs
    that substep as the identity: nothing accepted, nothing booked, one
    `skipped` count. The in-range count depends only on particles outside
    the colour's active cells, so it is invariant under the substep's own
    moves and the identity keeps the chain unbiased. A `trim_k` that cannot
    beat the (3^d - 1) * cap lanes turns the compaction off.
    """

    def __init__(self, spec: CBSpec, table: PairTable, pool, inner: int, max_bonds: int = 0,
                 trim_k: Optional[int] = None, trim_rcut: Optional[float] = None):
        from .base import displacement

        d = spec.d
        self.d, self.cap = d, spec.cap
        self.inner = max(1, int(inner))
        self.C = 2**d
        self.table = table
        self.pool = tuple(pool) if pool is not None else (displacement(1.0),)
        self.max_bonds = max_bonds
        self.molecular = max_bonds > 0
        check_pool(self.pool, self.molecular)
        self.n_moves = len(self.pool)
        self.submove_spans = [SUBMOVE_RANGE + submove_kind(mv) for mv in self.pool]
        self.submove_calls = [SUBMOVE_CALLS + submove_kind(mv) for mv in self.pool]
        self.species_live = any(mv.action in ("swap", "flip") for mv in self.pool)
        self.kinds = kinds_present(table)  # once here: it reads the table on the host
        rows = _slot_schedule(self.pool, self.C, self.inner).tolist()
        self.rows = rows
        # each colour's segments, with each move's slots relative to the
        # segment's start (for the counters): a slice where they are
        # contiguous, else a tuple that device_index puts on the device once
        self.segments = [
            [
                (k0, k1, on, [_rel_slots([k - k0 for k in range(k0, k1) if rows[ci][k] == m], m)
                              for m in sorted(set(rows[ci][k0:k1]))])
                for k0, k1, on in schedule_segments(rows[ci], self.pool, kernel=not self.molecular)
            ]
            for ci in range(self.C)
        ]
        self._on_device = {}  # (host index, device) -> device tensor
        self.on_kernel = any(seg[2] for segs in self.segments for seg in segs)
        # colours with a slot that is not the kernel's: they need each cell's
        # occupancy for the pick
        self.has_other = [any(not seg[2] for seg in segs) for segs in self.segments]
        # each slot's index into the SimpleGaussian moves' sigmas; other slots
        # take the first, since the kernel never reads their draws
        self.gauss = [m for m, mv in enumerate(self.pool) if _is_gaussian(mv)]
        self.sigma_idx = np.asarray([[self.gauss.index(m) if m in self.gauss else 0 for m in row] for row in rows])
        if trim_k is not None:
            trim_k = int(trim_k)
            if trim_rcut is None:
                trim_rcut = interaction_range(table)
            self.trim_r2 = float(trim_rcut) ** 2
            if trim_k >= (3**d - 1) * spec.cap:
                trim_k = None  # cannot beat the uncompacted lane count
        self.trim_k = trim_k

    def check_injected(self, up, ua, dl, up2):
        injected = [x is not None for x in (up, ua, dl)]
        if any(injected) and not all(injected):
            raise ValueError("inject up, ua and dl together")
        if up2 is not None and not self.species_live:
            raise ValueError("up2 is drawn only for pools with a swap or a flip")
        if all(injected) and self.species_live and up2 is None:
            raise ValueError("a pool with a swap or a flip needs up2 with up, ua and dl")

    def context(self, system: SystemState, pool_params) -> _Context:
        dt = system.position.dtype
        dev = system.position.device
        tabs = _Tables(self.table, self.kinds, dt, dev, self.molecular)
        sigmas = [
            p["sigma"].to(dev, dt) if mv.action == "displacement" else None
            for mv, p in zip(self.pool, pool_params)
        ]
        thetas = [
            (p["theta1"].to(dev, dt), p["theta2"].to(dev, dt)) if mv.policy == "energy_bias" else None
            for mv, p in zip(self.pool, pool_params)
        ]
        sigma_slot = None
        if self.on_kernel:
            sigma_slot = torch.stack([sigmas[m] for m in self.gauss])[self.device_index(self.sigma_idx, dev)]
        slot_iota = torch.arange(self.cap, device=dev) if any(self.has_other) else None
        return _Context(tabs, sigmas, thetas, sigma_slot, -system.temperature[:, None, None, None],
                        system.temperature, slot_iota)

    def device_index(self, host, dev):
        """A host index (an array or a tuple) as a device tensor, copied
        once per device: a copy from host memory would wait for the device
        at every call."""
        key = (id(host), dev)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(np.asarray(host), device=dev)
        return self._on_device[key]

    def round_draws(self, ctx: _Context, B: int, A: int, gen, injected, r: int, block: Optional[ChainBlock] = None):
        """One round's draws [B, C, inner, (d,) A]: the injected ones' round
        `r`, or fresh ones from `gen` (up, ua, dl, then up2 only for a pool
        with a swap or a flip); with the kernel's thresholds thr = -T log u
        and sigma-scaled steps dls. A chain shard (`block`) draws the global
        batch's shape, or is given it, and keeps its rows."""
        up, ua, dl, up2 = injected
        dt, dev = ctx.temperature.dtype, ctx.temperature.device
        with tracing.span("cb.draws"):
            if up is not None:
                up_r, ua_r, dl_r = up[:, r], ua[:, r], dl[:, r]
                up2_r = up2[:, r] if up2 is not None else None
            else:
                shape = (draw_batch(block, B), self.C, self.inner, A)
                up_r = torch.rand(shape, generator=gen, dtype=dt, device=dev) * (1.0 - 1e-7)
                ua_r = torch.clamp_min(torch.rand(shape, generator=gen, dtype=dt, device=dev), torch.finfo(dt).tiny)
                dl_r = torch.randn(shape[:3] + (self.d, A), generator=gen, dtype=dt, device=dev)
                up2_r = None
                if self.species_live:  # second per-cell pick (swap or flip partner)
                    up2_r = torch.rand(shape, generator=gen, dtype=dt, device=dev) * (1.0 - 1e-7)
            up_r, ua_r, dl_r = own_rows(up_r, block), own_rows(ua_r, block), own_rows(dl_r, block)
            up2_r = None if up2_r is None else own_rows(up2_r, block)
            rnd = {"up": up_r, "dl": dl_r, "up2": up2_r, "log_ua": torch.log(ua_r)}
            if self.on_kernel:
                # fold sigma and the temperature into the kernel's draws: it
                # compares ΔE with thr = -T log(u) and moves by dl * sigma
                rnd["thr"] = ctx.neg_t * rnd["log_ua"]
                rnd["dls"] = dl_r * ctx.sigma_slot[None, :, :, None, None]
        return rnd

    def compact(self, pos, sp, aux, lo, hi):
        """The candidate compaction of one substep (class docstring): lanes
        [.., cap + trim_k] (the molecular planes compacted alike), and ok [B],
        False for a chain with more than trim_k lanes in range in some cell."""
        cap, k = self.cap, self.trim_k
        B, d, A, LP = pos.shape
        dev = pos.device
        pos_o, sp_o = pos[..., cap:], sp[..., cap:]
        d2c = torch.zeros_like(sp_o)
        for j in range(d):
            x = pos_o[:, j]
            over = torch.clamp_min(torch.maximum(lo[j][:, None] - x, x - hi[j][:, None]), 0.0)
            d2c = d2c + over * over
        inr = (sp_o >= 0) & (d2c <= self.trim_r2)
        ok = ~torch.any(inr.sum(dim=-1) > k, dim=-1)
        # a stable partition: each kept lane's rank among the in-range ones
        rank = torch.cumsum(inr, dim=-1) - 1
        dst = torch.where(inr & (rank < k), rank, k)
        src = torch.full((B, A, k + 1), -1, dtype=torch.int64, device=dev)
        src.scatter_(-1, dst, torch.arange(cap, LP, device=dev).expand(B, A, LP - cap))
        src = src[..., :k]
        keep = torch.cat([torch.ones((B, A, cap), dtype=torch.bool, device=dev), src >= 0], dim=-1)
        idx = torch.cat([torch.arange(cap, device=dev).expand(B, A, cap), torch.clamp_min(src, 0)], dim=-1)
        L = cap + k
        pos_t = torch.gather(pos, -1, idx[:, None].expand(B, d, A, L))
        sp_t = torch.where(keep, torch.gather(sp, -1, idx), -1.0)
        if aux is not None:
            npm = aux.shape[1]
            aux = torch.where(keep[:, None], torch.gather(aux, -1, idx[:, None].expand(B, npm, A, L)), -1.0)
        return pos_t, sp_t, aux, ok

    def run(self, ctx: _Context, padded, spec: CBSpec, c, ci: int, lo, hi, rnd, energy, att, acc, write):
        """Colour `c`'s substep on the wrap-padded grid `padded` of `spec` (a
        slab's in the spatial backend): every slot of the colour's schedule
        row, the kernel on each run of SimpleGaussian slots. `lo`/`hi` [d, A]
        bound the active cells, `rnd` holds the colour's draws [B, inner, (d,)
        A]. `write(centre, centre_sp)` writes the centre lanes back into the
        grid; `att`/`acc` [B, n_moves] count in place. Returns the energy with
        the booked changes and, with trim, ok [B] (None without)."""
        cap = self.cap
        dt = padded.dtype
        tabs = ctx.tabs
        with tracing.span("cb.extract"):
            pos, sp, aux = extract_colour(padded, spec, c)
        ok_sub = None
        log_ua_c = rnd["log_ua"]
        if self.trim_k is not None:
            with tracing.span(TRIM_RANGE):
                pos, sp, aux, ok_sub = self.compact(pos, sp, aux, lo, hi)
            # a trim overflow: the substep is the identity for its chain
            log_ua_c = torch.where(ok_sub[:, None, None], log_ua_c, math.inf)
        mol = _Molecular(tabs, aux, cap, self.max_bonds) if self.molecular else None
        if self.has_other[ci]:
            occ = torch.sum(sp[..., :cap] >= 0, dim=-1)  # [B, A]; static in the substep
            occupied = occ > 0
            if ok_sub is not None:
                occupied = occupied & ok_sub[:, None]
            occupied_cells = occupied.sum(dim=-1)  # [B]
        centre = None  # the kernel's last centre positions, not yet in `pos`
        # the kernel runs' accepts, counted after the write-back: the
        # counters' index copy waits for the device, so the host issues the
        # write-back while the kernel still runs
        kernel_accepts = []
        up_c = rnd["up"]
        lanes = {} if self.trim_k is None else {"cap": cap}  # compacted: LP = cap + trim_k
        for k0, k1, kernel_run, moves in self.segments[ci]:
            if centre is not None:
                pos[..., :cap] = centre
                centre = None
            if kernel_run:
                with tracing.span("cb.kernel"):
                    thr = rnd["thr"][:, k0:k1]
                    thr = thr.contiguous() if ok_sub is None else torch.where(ok_sub[:, None, None], thr, -math.inf)
                    centre, booked, acc_k = disp_substep(
                        pos, sp, up_c[:, k0:k1].contiguous(), rnd["dls"][:, k0:k1].contiguous(),
                        thr, lo, hi, tabs.packed, kinds=self.kinds, **lanes,
                    )
                    energy = energy + torch.sum(booked.to(energy.dtype), dim=-1)
                kernel_accepts.append((moves, acc_k))
                continue
            k = k0
            m = self.rows[ci][k]
            mv = self.pool[m]
            cpos, csp = pos[..., :cap], sp[..., :cap]
            opos, osp = pos[..., cap:], sp[..., cap:]
            log_ua = log_ua_c[:, k]
            temperature = ctx.temperature
            if mv.action != "swap":  # floor(u * occ) is uniform over [0, occ)
                pick = ctx.slot_iota == torch.floor(up_c[:, k] * occ.to(dt)).long()[..., None]
            tracing.count(self.submove_calls[m])
            with tracing.span(self.submove_spans[m]):
                if mv.action == "displacement" and mv.policy == "smart":
                    new_pos, booked, accept = _disp_submove_smart(
                        tabs, cpos, csp, opos, osp, pick, rnd["dl"][:, k], ctx.sigmas[m],
                        lo, hi, occupied, log_ua, temperature,
                    )
                    pos[..., :cap] = new_pos
                elif mv.action == "displacement":
                    new_pos, booked, accept = mol.displacement(
                        cpos, csp, opos, osp, pick, ctx.sigmas[m] * rnd["dl"][:, k],
                        lo, hi, occupied, log_ua, temperature,
                    )
                    pos[..., :cap] = new_pos
                elif mv.policy == "energy_bias":
                    new_sp, booked, accept = _swap_submove_energy_bias(
                        tabs, *mv.species, cpos, csp, opos, osp, *ctx.thetas[m],
                        up_c[:, k], rnd["up2"][:, k], log_ua, temperature,
                    )
                    sp[..., :cap] = new_sp
                elif mv.action == "swap":
                    new_sp, booked, accept = _swap_submove_atomic(
                        tabs, *mv.species, cpos, csp, opos, osp,
                        up_c[:, k], rnd["up2"][:, k], log_ua, temperature,
                    )
                    sp[..., :cap] = new_sp
                else:
                    new_sp, booked, accept = mol.flip(
                        cpos, csp, opos, osp, pick, rnd["up2"][:, k], occupied, log_ua, temperature,
                    )
                    sp[..., :cap] = new_sp
            energy = energy + torch.sum(booked.to(energy.dtype), dim=-1)
            with tracing.span("cb.counters"):
                att[:, m] += occupied_cells
                acc[:, m] += accept.sum(dim=-1)
        if centre is None:
            centre = pos[..., :cap]
        with tracing.span("cb.write_back"):
            write(centre, sp[..., :cap] if self.species_live else None)
        with tracing.span("cb.counters"):
            if kernel_accepts and not self.has_other[ci]:
                occupied_cells = torch.sum(torch.any(sp[..., :cap] >= 0, dim=-1), dim=-1)  # [B]
                if ok_sub is not None:
                    occupied_cells = occupied_cells * ok_sub
            for moves, acc_k in kernel_accepts:
                for m, rel, count in moves:
                    att[:, m] += occupied_cells * count
                    idx = rel if isinstance(rel, slice) else self.device_index(rel, acc_k.device)
                    acc[:, m] += torch.sum(acc_k[..., idx], dim=(1, 2))
        return energy, ok_sub


def finish_block(cb: CBState, n: int, shift, planes, idx, slot, ovf, energy, att, acc, skp, species_live: bool):
    """The state after one rebin block: positions (and species) unbinned
    from the block's `planes`, the ledger `energy`, the counters `att`/`acc`
    [B, n_moves] and `skp` [B] trim-overflow substeps (or None) added.
    Skip-on-overflow: a chain whose shift overflowed a bucket keeps its
    state (its block is the identity; its validity is invariant under the
    block's own moves, so apply-if-valid-else-identity stays π-reversible),
    and counts one skip; the substep skips count only where the block
    applied."""
    system = cb.system
    d = system.dim
    box = system.box
    position = unbin_positions(planes, idx, n, shift, box)
    ok = ~ovf
    ok2 = ok[:, None]
    ok4 = ok[:, None, None, None]
    species = system.species
    if species_live:
        species = _unbin_planes(planes[:, d : d + 1], idx, n)[:, 0].to(species.dtype)
        species = torch.where(ok2, species, system.species)
    system = system.replace(
        position=torch.where(ok[:, None, None], position, system.position),
        species=species,
        energy=torch.where(ok, energy, system.energy),
    )
    skipped = cb.skipped + ovf.long()
    if skp is not None:
        skipped = skipped + torch.where(ok, skp, torch.zeros_like(skp))
    return cb.replace(
        system=system,
        shift=torch.where(ok2, shift, cb.shift),
        planes=torch.where(ok4, planes, cb.planes),
        idx=torch.where(ok[:, None, None], idx, cb.idx),
        slot=torch.where(ok2, slot, cb.slot),
        attempted=cb.attempted + torch.where(ok2, att, torch.zeros_like(att)),
        accepted=cb.accepted + torch.where(ok2, acc, torch.zeros_like(acc)),
        overflow=cb.overflow | ovf,
        skipped=skipped,
    )


def build_hyper_sweep_fn(
    spec: CBSpec,
    table: PairTable,
    n: int,
    sweepstep: Optional[int] = None,
    inner: int = 4,
    sweeps: int = 1,
    pool=None,
    max_bonds: int = 0,
    trim_k: Optional[int] = None,
    trim_rcut: Optional[float] = None,
):
    """Returns `hyper_sweep(cb, pool_params, *, shift=None, up=None,
    ua=None, dl=None, up2=None) -> CBState`: one rebin under a new grid
    shift, then `sweeps` hyper-sweeps of ~sweepstep (default n) attempted
    moves each, then one unbin of the positions (and species, when the pool
    changes them).

    A hyper-sweep is `rounds` rounds of the 2^d colour substeps with
    A * inner sub-moves each. `pool` is a tuple of Moves (moves/base.py);
    `pool_params` its parameter dicts (moves.base.init_pool_params).
    `max_bonds` is the bond-list width of a molecular system (0 for atoms);
    the grid of a molecular system must then be sized on
    tables.interaction_range. `trim_k` (size it with auto_trim_k) and
    `trim_rcut` turn on the candidate compaction (ColourSubsteps); unlike
    the JAX package, whose Pallas kernel packs only the untrimmed lanes, the
    compacted lanes still go through the CUDA kernel.

    The randomness can be injected so that a test can give this port and the
    JAX package the same numbers: `shift` [B, d] (in units of the box),
    `up`/`ua` [B, R, C, inner, A] uniforms, `dl` [B, R, C, inner, d, A]
    standard normals and, for a pool with a swap or a flip, `up2`
    [B, R, C, inner, A] (the second pick), with R = sweeps * rounds and
    C = 2^d. Otherwise they are drawn from `cb.generator` one round at a
    time: up, ua, dl, then up2 only for such a pool, so that an
    all-displacement pool's stream does not depend on it. A chain shard
    (`cb.chains`) draws at the global batch's shape and keeps its rows;
    injected draws are given at that shape too.
    """
    plan = ColourSubsteps(spec, table, pool, inner, max_bonds, trim_k, trim_rcut)
    d = spec.d
    A = spec.n_active
    C = plan.C
    cols = colours(d)
    rounds = max(1, -(-int(sweepstep or n) // (A * plan.inner * C)))
    R = max(1, int(sweeps)) * rounds

    def hyper_sweep(cb: CBState, pool_params, *, shift=None, up=None, ua=None, dl=None, up2=None):
        with tracing.span("cb.block"):
            system = cb.system
            B = system.n_chains
            dt = system.position.dtype
            dev = system.position.device
            box = system.box
            plan.check_injected(up, ua, dl, up2)
            with tracing.span("cb.rebin"):  # the block's start
                ctx = plan.context(system, pool_params)
                if shift is None:
                    shift = torch.rand((draw_batch(cb.chains, B), d), generator=cb.generator, dtype=dt, device=dev)
                shift = own_rows(shift, cb.chains) * box
                planes0, idx, slot, ovf = rebin(system, spec, shift)
                padded = pad_grid(planes0, spec, box)
                bounds = [cell_bounds(spec, box[0], c) for c in cols]
                energy = system.energy.clone()
                att = torch.zeros((B, plan.n_moves), dtype=torch.int64, device=dev)
                acc = torch.zeros((B, plan.n_moves), dtype=torch.int64, device=dev)
                skp = torch.zeros(B, dtype=torch.int64, device=dev) if plan.trim_k is not None else None
            for r in range(R):
                rnd = plan.round_draws(ctx, B, A, cb.generator, (up, ua, dl, up2), r, cb.chains)
                for ci, c in enumerate(cols):
                    with tracing.span("cb.substep"):
                        def write(centre, centre_sp, c=c):
                            write_back(padded, spec, c, centre, box, centre_sp)

                        rnd_c = {key: v[:, ci] for key, v in rnd.items() if v is not None}
                        energy, ok_sub = plan.run(ctx, padded, spec, c, ci, *bounds[ci], rnd_c, energy, att, acc, write)
                        if ok_sub is not None:
                            skp = skp + (~ok_sub).long()
            with tracing.span("cb.finish"):
                interior = (slice(None), slice(None)) + (slice(1, -1),) * d
                planes = padded[interior].reshape(planes0.shape)
                return finish_block(cb, n, shift, planes, idx, slot, ovf, energy, att, acc, skp, plan.species_live)

    hyper_sweep.plan = plan
    return hyper_sweep

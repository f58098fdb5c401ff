"""Spatial slab decomposition of the checkerboard grid (counterpart of
particlesmc_tpu/parallel/spatial.py): one system too large for one device.

The grid is cut along its first dimension into P slabs, one per entry of a
Mesh (parallel/mesh.py). Slab p owns w = ncells[0] / P cell columns starting
at the even column p * w, so its colours are the global colours and every
slab steps the same schedule. A slab keeps its cells wrap-padded in the
dimensions >= 1 (whole there, image-corrected as in moves/checkerboard.py)
and one halo column on each side in dimension 0, which holds the
neighbouring slab's boundary column; the column that crosses the periodic
seam carries x -/+ L. A sub-move reads only the 3^d cells around its active
cell, so after each colour substep's halo exchange every slab reads exactly
what the unsharded grid holds.

Each colour substep, every slab runs the substep of moves/checkerboard.py on
its A / P active cells (ColourSubsteps.run: the CUDA kernel on each run of
SimpleGaussian slots, against the global cell bounds, and the swap sub-moves
in plain PyTorch), writes its centre cells back, refreshes its halos in the
dimensions >= 1, and then the slabs exchange their dimension-0 halos. The
binning and the unbinning stay global. The draws have the unsharded
hyper-sweep's layout, [B, C, inner, A] per round, and slab p takes its
contiguous block of the x-major active axis, so a sharded run makes the
unsharded run's moves on the same generator. The booked energy and the
counters are summed over the slabs; the skip-on-overflow is the unsharded
one. The spatial backend runs untrimmed, as the JAX package's does.

Two transports of the halo columns sit behind one interface: copies between
the slabs' tensors for a device list in one process, and
`torch.distributed` point-to-point messages between the ranks of a process
group, where every rank holds the whole state, runs the global binning and
draws itself, and steps its own slab.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.tables import PairTable
from ..moves.checkerboard import (
    CBSpec,
    CBState,
    ColourSubsteps,
    cell_bounds,
    colours,
    finish_block,
    rebin,
    write_back,
)
from .mesh import Mesh

# profiler range around each exchange of the dimension-0 halo columns
HALO_RANGE = "cb_halo"


def spatial_slab_width(spec: CBSpec, n_devices: int) -> Optional[int]:
    """Cell columns per device, or None if the grid cannot be sharded over
    `n_devices` (ncells[0] must split into even slabs of >= 2 columns)."""
    ncx = spec.ncells[0]
    if ncx % n_devices:
        return None
    w = ncx // n_devices
    if w < 2 or w % 2:
        return None
    return w


def _pad_slab(slab, box, ncells):
    """A slab [B, NP, w, nc1.., cap] padded by one cell per side in every
    dimension: wrap-padded and image-corrected in the dimensions >= 1, with
    two halo columns in dimension 0 for the exchange to fill."""
    B, NP = slab.shape[:2]
    d = len(ncells)
    grid = slab
    for k in range(1, d):
        ax = 2 + k
        grid = torch.cat([grid.narrow(ax, grid.shape[ax] - 1, 1), grid, grid.narrow(ax, 0, 1)], dim=ax)
    for j in range(1, d):
        lo = (slice(None), j) + (slice(None),) * j + (0,)
        hi = (slice(None), j) + (slice(None),) * j + (ncells[j] + 1,)
        corr = box[:, j].reshape((B,) + (1,) * (grid.dim() - 3))
        grid[lo] = grid[lo] + (-corr)
        grid[hi] = grid[hi] + corr
    halo = torch.zeros_like(grid.narrow(2, 0, 1))
    return torch.cat([halo, grid, halo], dim=2)


class _ListExchange:
    """The transport of a device list: every slab in this process, halo
    columns copied between their tensors."""

    def __init__(self, mesh: Mesh):
        self.P = mesh.size

    def halos(self, slabs, lx):
        """Fill each slab's dimension-0 halo columns from its neighbours'
        boundary columns; the seam's columns carry x -/+ L (lx [B] per slab's
        device)."""
        P = self.P
        w = slabs[0].shape[2] - 2
        for p in range(P):
            right, left = slabs[(p + 1) % P], slabs[(p - 1) % P]
            slabs[p][:, :, w + 1].copy_(right[:, :, 1])
            slabs[p][:, :, 0].copy_(left[:, :, w])
            if p == P - 1:
                _shift_x(slabs[p], w + 1, lx[p])
            if p == 0:
                _shift_x(slabs[p], 0, -lx[p])

    def reduce(self, parts):
        """The sum of every slab's partial tensor, on slab 0's device."""
        out = parts[0]
        for t in parts[1:]:
            out = out + t.to(out.device)
        return out

    def gather(self, interiors, device):
        """The slabs' interiors as one grid [B, NP, ncells[0], .., cap]."""
        return torch.cat([t.to(device) for t in interiors], dim=2)


class _GroupExchange:
    """The transport of a process group: one slab per rank, halo columns sent
    to the neighbouring ranks. gloo moves only CPU tensors, so under gloo a
    card's column goes through the CPU; nccl moves the card's tensors."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.P = mesh.size
        self.rank = mesh.first
        self.staged = mesh.backend == "gloo"
        g = mesh.group
        self.left = dist.get_global_rank(g, (self.rank - 1) % self.P)
        self.right = dist.get_global_rank(g, (self.rank + 1) % self.P)

    def _wire(self, t):
        """`t` as a contiguous tensor the backend can move (a copy)."""
        return (t.cpu() if self.staged else t).contiguous()

    def halos(self, slabs, lx):
        (s,) = slabs
        w = s.shape[2] - 2
        if self.P == 1:
            _ListExchange(self.mesh).halos(slabs, lx)
            return
        g = self.mesh.group
        to_left, to_right = self._wire(s[:, :, 1]), self._wire(s[:, :, w])
        from_right, from_left = torch.empty_like(to_left), torch.empty_like(to_right)
        # tags keep the two messages of a P = 2 pair apart under gloo; nccl
        # matches a pair's messages in order, which is the same order here
        ops = [
            dist.P2POp(dist.isend, to_left, self.left, g, tag=0),
            dist.P2POp(dist.isend, to_right, self.right, g, tag=1),
            dist.P2POp(dist.irecv, from_right, self.right, g, tag=0),
            dist.P2POp(dist.irecv, from_left, self.left, g, tag=1),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        s[:, :, w + 1].copy_(from_right)
        s[:, :, 0].copy_(from_left)
        if self.rank == self.P - 1:
            _shift_x(s, w + 1, lx[0])
        if self.rank == 0:
            _shift_x(s, 0, -lx[0])

    def reduce(self, parts):
        (t,) = parts
        buf = self._wire(t).clone()  # all_reduce works in place
        dist.all_reduce(buf, group=self.mesh.group)
        return buf.to(t.device)

    def gather(self, interiors, device):
        (t,) = interiors
        buf = self._wire(t)
        out = [torch.empty_like(buf) for _ in range(self.P)]
        dist.all_gather(out, buf, group=self.mesh.group)
        return torch.cat(out, dim=2).to(device)


def _shift_x(slab, col, lx):
    """Add lx [B] to the x plane of halo column `col` (the periodic seam's
    image correction)."""
    x = slab[:, 0, col]
    x += lx.reshape((-1,) + (1,) * (x.dim() - 1))


def build_spatial_hyper_sweep_fn(
    spec: CBSpec,
    table: PairTable,
    n: int,
    mesh: Mesh,
    sweepstep: Optional[int] = None,
    inner: int = 4,
    sweeps: int = 1,
    pool=None,
):
    """Returns the slab-decomposed `hyper_sweep(cb, pool_params, *,
    shift=None, up=None, ua=None, dl=None, up2=None) -> CBState` over
    `mesh`'s slabs: the function and the injected draws of
    moves/checkerboard.py::build_hyper_sweep_fn, whose run on the same
    generator it reproduces. Pools of Displacement (SimpleGaussian) and
    DiscreteSwap/DoubleUniform moves on atomic systems. State in and out is
    an ordinary CBState on one device (under a process group, each rank's
    own, equal on every rank)."""
    P = mesh.size
    w = spatial_slab_width(spec, P)
    if w is None:
        raise ValueError(
            f"grid ncells[0]={spec.ncells[0]} cannot shard into even slabs over {P} devices"
        )
    for mv in pool if pool is not None else ():
        ok = mv.action == "displacement" or (mv.action == "swap" and mv.policy == "double_uniform")
        if not ok:
            raise ValueError(
                f"spatial backend supports Displacement and DiscreteSwap/DoubleUniform pools on "
                f"atomic systems; {mv.action}/{mv.policy} needs another backend"
            )
    plan = ColourSubsteps(spec, table, pool, inner)
    d = spec.d
    C = plan.C
    cols = colours(d)
    A = spec.n_active
    A_l = A // P
    local = CBSpec(ncells=(w,) + tuple(spec.ncells[1:]), cap=spec.cap)
    rounds = max(1, -(-int(sweepstep or n) // (A * plan.inner * C)))
    R = max(1, int(sweeps)) * rounds
    exchange = _ListExchange(mesh) if mesh.group is None else _GroupExchange(mesh)
    slabs_here = list(range(mesh.first, mesh.first + len(mesh.devices)))

    def hyper_sweep(cb: CBState, pool_params, *, shift=None, up=None, ua=None, dl=None, up2=None):
        system = cb.system
        B = system.n_chains
        dt = system.position.dtype
        dev = system.position.device
        box = system.box
        plan.check_injected(up, ua, dl, up2)
        if shift is None:
            shift = torch.rand((B, d), generator=cb.generator, dtype=dt, device=dev)
        shift = shift * box
        planes0, idx, slot, ovf = rebin(system, spec, shift)
        grid = planes0.reshape((B, planes0.shape[1]) + spec.ncells + (spec.cap,))
        bounds = [cell_bounds(spec, box[0], c) for c in cols]
        ctx0 = plan.context(system, pool_params)
        slabs, ctxs, lims, energies, atts, accs, boxes = [], [], [], [], [], [], []
        for i, p in enumerate(slabs_here):
            sdev = mesh.devices[i]
            sys_p = system.replace(box=box.to(sdev), temperature=system.temperature.to(sdev))
            boxes.append(sys_p.box)
            slabs.append(_pad_slab(grid[:, :, p * w:(p + 1) * w].to(sdev), sys_p.box, spec.ncells))
            ctxs.append(ctx0 if sdev == dev else plan.context(sys_p, pool_params))
            a0 = p * A_l
            lims.append([(lo[:, a0:a0 + A_l].contiguous().to(sdev), hi[:, a0:a0 + A_l].contiguous().to(sdev))
                         for lo, hi in bounds])
            energies.append(torch.zeros(B, dtype=system.energy.dtype, device=sdev))
            atts.append(torch.zeros((B, plan.n_moves), dtype=torch.int64, device=sdev))
            accs.append(torch.zeros((B, plan.n_moves), dtype=torch.int64, device=sdev))
        lx = [b[:, 0] for b in boxes]
        with torch.profiler.record_function(HALO_RANGE):
            exchange.halos(slabs, lx)
        for r in range(R):
            rnd = plan.round_draws(ctx0, B, A, cb.generator, (up, ua, dl, up2), r)
            for ci, c in enumerate(cols):
                for i, p in enumerate(slabs_here):
                    sdev = mesh.devices[i]
                    a0 = p * A_l
                    rnd_c = {key: v[:, ci, ..., a0:a0 + A_l].to(sdev) for key, v in rnd.items() if v is not None}

                    def write(centre, centre_sp, slab=slabs[i], c=c, bx=boxes[i]):
                        write_back(slab, local, c, centre, bx, centre_sp, first_dim=1)

                    energies[i], _ = plan.run(ctxs[i], slabs[i], local, c, ci, *lims[i][ci], rnd_c,
                                              energies[i], atts[i], accs[i], write)
                with torch.profiler.record_function(HALO_RANGE):
                    exchange.halos(slabs, lx)
        interior = (slice(None), slice(None), slice(1, w + 1)) + (slice(1, -1),) * (d - 1)
        planes = exchange.gather([s[interior] for s in slabs], dev).reshape(planes0.shape)
        energy = system.energy + exchange.reduce(energies).to(system.energy.device)
        att = exchange.reduce(atts).to(dev)
        acc = exchange.reduce(accs).to(dev)
        return finish_block(cb, n, shift, planes, idx, slot, ovf, energy, att, acc, None, plan.species_live)

    hyper_sweep.plan = plan
    return hyper_sweep

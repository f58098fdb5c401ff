"""Fixed-shape bucketed cell list, batched over chains (counterpart of
particlesmc_tpu/core/neighbours.py).

The sequential kernel has two neighbour modes:

- dense: every particle is a candidate (the O(N) oracle);
- cell: a bucketed grid `bucket [B, ncells, cap]` (-1 padded) with
  `count [B, ncells]` and `cell_of [B, N]`, built by a stable sort and a
  scatter and kept up to date by O(cap) row surgery on every step
  (`move_particle`). A capacity overflow drops the insert and sets the
  chain's sticky `overflow` flag; the engine raises on it.

Bucket order is the JAX package's: a fresh build lists each cell's particles
in ascending id (up to `cap`), an insert appends, and a removal fills its
slot with the row's last occupant. Candidate order, and so the order of the
ΔE sums, follows.

Queries gather the 3^d cell rows around the query position, giving a fixed
[3^d * cap] candidate vector (-1 padded) per query.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .geometry import fold_back


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Static grid geometry."""

    ncells: Tuple[int, ...]  # cells per dimension, each >= 3
    cap: int  # bucket capacity

    @property
    def total(self) -> int:
        return int(np.prod(self.ncells))

    @property
    def n_neighbour_cells(self) -> int:
        return 3 ** len(self.ncells)


@dataclasses.dataclass(frozen=True)
class CellList:
    """Bucketed cell lists of B chains."""

    bucket: torch.Tensor  # [B, ncells_total, cap] int64, -1 padded
    count: torch.Tensor  # [B, ncells_total] int64
    cell_of: torch.Tensor  # [B, N] int64
    overflow: torch.Tensor  # [B] bool, sticky: an insert was dropped

    def replace(self, **kw) -> "CellList":
        return dataclasses.replace(self, **kw)


def make_spec(box, rcut: float, n: int, cap: Optional[int] = None) -> Optional[CellSpec]:
    """Choose the grid for a host-side box [d]. None when a grid cannot beat
    O(N) (fewer than 3 cells in some dimension)."""
    box = np.asarray(box, np.float64)
    ncells = tuple(int(x) for x in np.floor(box / rcut))
    if min(ncells) < 3:
        return None
    if cap is None:
        mean_occ = n / float(np.prod(ncells))
        cap = max(8, int(math.ceil(mean_occ * 3.0)))
    return CellSpec(ncells=ncells, cap=int(cap))


@functools.lru_cache(maxsize=32)
def _grid(ncells: Tuple[int, ...], device: torch.device, dtype: torch.dtype):
    """Device constants of a grid: cells per dimension as `dtype` and as
    int64, the ravel strides, and the 3^d neighbour offsets. Made once per
    (grid, device, dtype), so that no query copies from the host."""
    d = len(ncells)
    strides = [int(np.prod(ncells[k + 1:])) for k in range(d)]
    offsets = list(itertools.product((-1, 0, 1), repeat=d))
    return (
        torch.tensor(ncells, dtype=dtype, device=device),
        torch.tensor(ncells, dtype=torch.int64, device=device),
        torch.tensor(strides, dtype=torch.int64, device=device),
        torch.tensor(offsets, dtype=torch.int64, device=device),
    )


def _cell_vec(x, box, spec: CellSpec):
    """Per-dimension cell coordinates [..., d] of positions x [..., d]
    (folded into `box`, which broadcasts against x)."""
    ncf, nci, _, _ = _grid(spec.ncells, x.device, x.dtype)
    c = torch.floor(fold_back(x, box) / box * ncf).long()
    return torch.minimum(torch.clamp_min(c, 0), nci - 1)


def _ravel(cvec, spec: CellSpec):
    _, _, strides, _ = _grid(spec.ncells, cvec.device, torch.float64)
    return torch.sum(cvec * strides, dim=-1)


def cell_index(x, box, spec: CellSpec):
    """Cell ids [...] of positions x [..., d]."""
    return _ravel(_cell_vec(x, box, spec), spec)


def build_cell_list(position, box, spec: CellSpec) -> CellList:
    """Full rebuild of every chain's list: position [B, N, d], box [B, d].
    A stable sort by cell id orders the particles; each particle's rank in
    its cell's run is its lane, and lanes past `cap` are dropped (and set
    the chain's overflow flag)."""
    B, n, _ = position.shape
    dev = position.device
    cell = cell_index(position, box[:, None, :], spec)  # [B, N]
    sorted_cell, order = torch.sort(cell, dim=-1, stable=True)
    first = torch.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < spec.cap
    flat = torch.where(keep, sorted_cell * spec.cap + rank, spec.total * spec.cap)
    bucket = torch.full((B, spec.total * spec.cap + 1), -1, dtype=torch.int64, device=dev)
    bucket.scatter_(1, flat, order)
    count = torch.zeros((B, spec.total), dtype=torch.int64, device=dev)
    count.scatter_add_(1, cell, torch.ones_like(cell))
    overflow = torch.any(count > spec.cap, dim=-1)
    return CellList(
        bucket=bucket[:, :-1].reshape(B, spec.total, spec.cap),
        count=torch.clamp_max(count, spec.cap),
        cell_of=cell,
        overflow=overflow,
    )


def neighbour_cells_of(x, box, spec: CellSpec):
    """Ravelled ids [..., 3^d] of the cells around positions x [..., d]."""
    _, nci, _, offsets = _grid(spec.ncells, x.device, x.dtype)
    c = _cell_vec(x, box, spec)[..., None, :]  # [..., 1, d]
    return _ravel(torch.remainder(c + offsets, nci), spec)


def candidates_around(x, box, clist: CellList, spec: CellSpec):
    """Candidate ids [B, Q, 3^d * cap] (-1 padded) near positions x
    [B, Q, d]; `box` [B, d]."""
    B, Q = x.shape[:2]
    cells = neighbour_cells_of(x, box[:, None, :], spec)  # [B, Q, 3^d]
    rows = torch.gather(
        clist.bucket, 1, cells.reshape(B, -1, 1).expand(-1, -1, spec.cap)
    )  # [B, Q * 3^d, cap]
    return rows.reshape(B, Q, -1)


def move_particle(clist: CellList, i, new_cell) -> CellList:
    """Row surgery after particle i [B] moved to cell new_cell [B] (a no-op
    for a chain whose cell did not change): i leaves its old row (its slot
    takes the row's last occupant) and is appended to the new one. An insert
    into a full row is dropped and sets the chain's sticky overflow flag.
    Functional: the input list is not modified."""
    out = clist.replace(
        bucket=clist.bucket.clone(), count=clist.count.clone(),
        cell_of=clist.cell_of.clone(), overflow=clist.overflow.clone(),
    )
    move_particle_(out, i, new_cell)
    return out


def move_particle_(clist: CellList, i, new_cell) -> None:
    """In-place `move_particle` on the list's own tensors."""
    bucket, count = clist.bucket, clist.count
    B, _, cap = bucket.shape
    row_idx = lambda c: c[:, None, None].expand(B, 1, cap)  # noqa: E731
    old_cell = torch.gather(clist.cell_of, 1, i[:, None])[:, 0]
    changed = old_cell != new_cell

    # remove i from its old row: its slot takes the last occupant
    row_o = torch.gather(bucket, 1, row_idx(old_cell))[:, 0]  # [B, cap]
    cnt_o = torch.gather(count, 1, old_cell[:, None])[:, 0]
    pos = torch.argmax((row_o == i[:, None]).to(torch.uint8), dim=-1)
    last = torch.remainder(cnt_o - 1, cap)
    row_o_new = row_o.scatter(1, pos[:, None], torch.gather(row_o, 1, last[:, None]))
    row_o_new.scatter_(1, last[:, None], -1)

    # append i to the new row, unless it is full
    row_n = torch.gather(bucket, 1, row_idx(new_cell))[:, 0]
    cnt_n = torch.gather(count, 1, new_cell[:, None])[:, 0]
    would_overflow = cnt_n >= cap
    row_n_new = row_n.scatter(1, torch.clamp_max(cnt_n, cap - 1)[:, None], i[:, None])

    ch = changed[:, None]
    bucket.scatter_(1, row_idx(old_cell), torch.where(ch, row_o_new, row_o)[:, None])
    keep_n = torch.gather(bucket, 1, row_idx(new_cell))[:, 0]
    row_n_final = torch.where(would_overflow[:, None], row_n, row_n_new)
    bucket.scatter_(1, row_idx(new_cell), torch.where(ch, row_n_final, keep_n)[:, None])
    delta = changed.long()
    count.scatter_add_(1, old_cell[:, None], -delta[:, None])
    count.scatter_add_(1, new_cell[:, None], (delta * (~would_overflow).long())[:, None])
    clist.cell_of.scatter_(1, i[:, None], new_cell[:, None])
    clist.overflow.logical_or_(changed & would_overflow)

"""Structural observables: g(r), F_s(k, t), MSD (counterpart of
particlesmc_tpu/analysis/structure.py).

Each function computes in float64 on the device of its input: a tensor stays
where it is, a numpy array or a list goes to `device` (runtime.resolve_device:
the card unless the caller names another, and a raise without one). Results
come back as numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.geometry import min_image
from ..runtime import resolve_device

# pair distances held at once by radial_distribution: [rows, N] per chunk
_PAIR_BUDGET = 1 << 24


def _f64(x, device=None) -> torch.Tensor:
    """`x` as a float64 tensor: on its own device if it is a tensor, else on
    resolve_device(`device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=resolve_device(device))


def _box(box, dev: torch.device) -> torch.Tensor:
    """The box as a float64 tensor on `dev`, the device of the positions."""
    if isinstance(box, torch.Tensor):
        return box.to(dev, torch.float64)
    return torch.as_tensor(np.asarray(box, np.float64), device=dev)


def radial_distribution(
    position,
    box,
    nbins: int = 100,
    rmax: Optional[float] = None,
    species=None,
    pair: Optional[Tuple[int, int]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Radial distribution function g(r) with minimum-image distances.

    position: [N, d] or [M, N, d] (frames or chains are averaged). pair =
    (s1, s2) restricts to that species pair (0-based ids, `species` [N]).
    Returns (bin centres, g). The histogram has np.histogram's bins (the last
    one closed); the distances of each frame are taken in chunks of
    reference particles so that N = 10,000 fits. Normalisation uses the
    d-dimensional shell volume.
    """
    pos = _f64(position, device)
    if pos.dim() == 2:
        pos = pos[None]
    dev = pos.device
    box_t = _box(box, dev)
    box_np = box_t.cpu().numpy()
    d = pos.shape[-1]
    if rmax is None:
        rmax = float(box_np.min()) / 2
    edges_np = np.linspace(0.0, rmax, nbins + 1)
    edges = torch.as_tensor(edges_np, device=dev)
    counts = torch.zeros(nbins, dtype=torch.int64, device=dev)
    n = pos.shape[1]
    if species is not None and pair is not None:
        sp = torch.as_tensor(np.asarray(species.cpu() if isinstance(species, torch.Tensor) else species))
        sel_a = torch.nonzero(sp == pair[0]).reshape(-1).to(dev)
        sel_b = torch.nonzero(sp == pair[1]).reshape(-1).to(dev)
        same = pair[0] == pair[1]
    else:
        sel_a = sel_b = torch.arange(n, device=dev)
        same = True
    na, nb = len(sel_a), len(sel_b)
    rows = max(1, _PAIR_BUDGET // max(1, nb * d))
    for frame in pos:
        xb = frame[sel_b]
        for a0 in range(0, na, rows):
            ia = sel_a[a0:a0 + rows]
            dx = min_image(frame[ia][:, None, :] - xb[None, :, :], box_t)
            r2 = dx[..., 0] * dx[..., 0]
            for j in range(1, d):  # one fixed order, so that every device bins alike
                r2 = r2 + dx[..., j] * dx[..., j]
            r = torch.sqrt(r2)
            if same:  # leave out each particle's distance to itself
                r = r[ia[:, None] != sel_b[None, :]]
            r = r.reshape(-1)
            r = r[r <= rmax]
            # np.histogram's bins: [e_i, e_i+1), the last one closed
            k = torch.clamp_max(torch.bucketize(r, edges, right=True) - 1, nbins - 1)
            counts += torch.bincount(k, minlength=nbins)
    n_ref = na * pos.shape[0]
    vol = float(np.prod(box_np))
    rho_other = nb / vol
    if d == 2:
        shell = np.pi * (edges_np[1:] ** 2 - edges_np[:-1] ** 2)
    else:
        shell = 4.0 / 3.0 * np.pi * (edges_np[1:] ** 3 - edges_np[:-1] ** 3)
    centres = 0.5 * (edges_np[1:] + edges_np[:-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        g = counts.cpu().numpy().astype(np.float64) / (max(n_ref, 1) * rho_other * shell)
    return centres, g


def _wavevectors(box: np.ndarray, k_mod: float, tol: float, max_vectors: int) -> np.ndarray:
    """Box-commensurate wavevectors [K, d] with |k| within tol * k_mod of
    k_mod, in the JAX package's order."""
    base = 2 * np.pi / box
    nmax = [int(np.ceil(k_mod / b)) + 2 for b in base]
    grids = np.meshgrid(*[list(range(-m, m + 1)) for m in nmax], indexing="ij")
    ks = []
    for idx in np.stack([g.reshape(-1) for g in grids], -1):
        k = base * idx
        knorm = np.linalg.norm(k)
        if knorm > 0 and abs(knorm - k_mod) < tol * k_mod:
            ks.append(k)
    return np.asarray(ks[:max_vectors])


def self_intermediate_scattering(
    positions, box, k_mod: float, tol: float = 0.15, max_vectors: int = 50, device=None,
) -> np.ndarray:
    """F_s(k, t) = <cos(k · (r_i(t) - r_i(0)))>, averaged over particles and
    over the box-commensurate wavevectors with |k| ≈ k_mod. positions
    [T, N, d] must be unwrapped-consistent across frames."""
    pos = _f64(positions, device)
    dev = pos.device
    box_np = np.asarray(box.cpu() if isinstance(box, torch.Tensor) else box, np.float64)
    ks = torch.as_tensor(_wavevectors(box_np, k_mod, tol, max_vectors), device=dev)  # [K, d]
    disp = pos - pos[0]
    phase = disp @ ks.T  # [T, N, K]
    return torch.cos(phase).mean(dim=(1, 2)).cpu().numpy()


def _unwrap(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    steps = torch.diff(pos, dim=0)
    steps = steps - box * torch.round(steps / box)
    return torch.cat([pos[:1], pos[0] + torch.cumsum(steps, dim=0)], dim=0)


def unwrap_trajectory(positions, box, device=None) -> np.ndarray:
    """Undo periodic folding by frame-to-frame minimum-image unwrapping: each
    step between consecutive frames is taken as its minimum image and
    accumulated, which is exact while every per-particle displacement between
    consecutive frames is below box/2. positions [T, N, d] folded frames;
    returns [T, N, d] unwrapped."""
    pos = _f64(positions, device)
    return _unwrap(pos, _box(box, pos.device)).cpu().numpy()


def mean_squared_displacement(positions, box=None, device=None) -> np.ndarray:
    """MSD(t) relative to the first frame. With `box`, the frames are folded
    coordinates and are unwrapped first (unwrap_trajectory); without it they
    must already be unwrapped."""
    pos = _f64(positions, device)
    if box is not None:
        pos = _unwrap(pos, _box(box, pos.device))
    disp = pos - pos[0]
    return torch.sum(disp * disp, dim=-1).mean(dim=-1).cpu().numpy()

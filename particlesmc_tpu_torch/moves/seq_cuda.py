"""Sequential sweep on the card: wrapper of the CUDA kernel csrc/seq_sweep.cuh,
built as two libraries with the same entry points: csrc/seq_disp_sweep.cu
(pools of Gaussian displacements) and csrc/seq_swap_sweep.cu (pools that add
DoubleUniform and EnergyBias species swaps), so that a displacement pool never
waits for the swap variants' build; `sweep` picks the library from its inputs.
Each launch adds one to the counter
`seq_cuda.launches` and its chains times steps to `seq_cuda.steps`, a launch of
a swap variant one to `seq_cuda.swap_launches` too (tracing.counters()); each
nvcc build is one call of the `setup.kernel_build` phase (tracing.totals()).

Replaces no TPU kernel: the JAX package runs the sequential step as XLA ops.
One launch runs every step of one sweep of every chain, for a pool of Gaussian
displacements, DoubleUniform swaps and EnergyBias swaps, with the dense ΔE, on
an atomic system (moves/kernel.py::takes_sweep_kernel decides). Per chain and
step, in order, on the sweep's draws:
- a displacement: particle i = pick, δ = σ[move] · normal, ΔE = Σ over
  j ≠ i of u(r²_new) − u(r²_old) with the minimum image in the chain's box,
  computed in the position dtype; accept iff ΔE is finite and
  log u < (−ΔE / T + log q) − log q (log q of the symmetric Gaussian, as the
  plain step adds and subtracts it); on accept x_i moves, unwrapped, and the
  ledger adds ΔE. A ΔE with an infinite term rejects, as in the plain step,
  where e_i + 0 · e_i is NaN then; so an accepted displacement always books
  its ΔE;
- a swap exchanges the species of i and j: for DoubleUniform the r1-th member
  of species s1 and the r2-th of s2 in id order, for EnergyBias the argmax of
  θ e + Gumbel noise over each species, e the chain's per-particle energies;
  log q, the acceptance, the ledger and the rules for an empty population
  and an infinite energy are the plain step's (moves/kernel.py).
With an EnergyBias swap in the pool each chain keeps its per-particle energies
on chip, in the ledger's dtype (float64 in mixed precision): one dense pass
at the launch's start, then every move updates them from the pair terms of its
ΔE pass, O(N) per step.

What bounds it on an H100: the latency of the chain of dependent steps. A
step needs about 30 N operations (a swap about 60 N) and a few hundred bytes,
so the card's rates allow far less than a microsecond; each step ends in one
to three reductions over the chain's particles that the next step waits for.
The design: one block per chain for the whole sweep, its positions, species
and energies in shared memory where they fit (else read through L2), one
block barrier and two warp butterflies per reduction, the next step's draws
loaded during the current one (the source's header has the details). No
floating atomics, a fixed reduction order: a launch is bitwise reproducible.

The wrapper takes CUDA tensors only and never falls back: the plain version
is the plain step of moves/kernel.py, which every CPU sweep runs
(`build_sweep_fn(...).plain` runs it on card tensors too). The kernels are
built with nvcc at first use, as cb_cuda's is, into
`particlesmc_tpu_torch/_build/`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from ..models.potentials import PAIR_FIELDS
from .cb_cuda import _PKG, build_library, kernel_variant, pack_table, table_kinds

SOURCE = _PKG / "csrc" / "seq_disp_sweep.cu"
SWAP_SOURCE = _PKG / "csrc" / "seq_swap_sweep.cu"
MAX_THREADS = 512

# the kernel's kinds of pool move (csrc/seq_sweep.cuh::MoveKind)
MOVE_KINDS = {("displacement", "gaussian"): 0, ("swap", "double_uniform"): 1, ("swap", "energy_bias"): 2}


@functools.lru_cache(maxsize=None)
def _library(swaps: bool = False) -> ctypes.CDLL:
    path = build_library(SWAP_SOURCE if swaps else SOURCE)
    with tracing.phase("setup.kernel_load"):
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seq_sweep.argtypes = [i] * 6 + [p] * 16 + [i] * 6 + [p] * 6
        lib.seq_sweep.restype = i
        lib.seq_sweep_plan.argtypes = [i] * 9 + [p, p]
        lib.seq_sweep_plan.restype = i
        lib.seq_error_string.argtypes = [i]
        lib.seq_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what} failed: {lib.seq_error_string(code).decode()}")


def threads_for(n: int) -> int:
    """Threads per block (chain) for n particles: four particles per thread,
    a multiple of 32 in [64, MAX_THREADS]. At N = 1,000 (2D JBB, 64 chains)
    256 threads took 1.19 ms per sweep in mixed precision, against 2.19,
    1.56, 1.28 and 1.22 ms at 64, 128, 384 and 512 (H100, CUDA events)."""
    return min(MAX_THREADS, max(64, 32 * -(-int(n) // 128)))


def move_table(pool) -> list:
    """The kernel's move table of a pool, [M] rows (kind, s1, s2): MOVE_KINDS's
    kind, and a swap's two species (0 for a displacement)."""
    return [[MOVE_KINDS[(mv.action, mv.policy)], *(mv.species or (0, 0))] for mv in pool]


def launch_plan(dtype, d: int, n: int, S: int, M: int, *, ledger=None, swaps: bool = False, bias: bool = False):
    """The launcher's choice for these shapes on the current card: (threads
    per block, dynamic shared memory bytes of a block, whether the chain's
    positions live in shared memory (else they are read through L2)). With
    `swaps` the plan of the swap variants (`bias`: with per-particle
    energies in `ledger`'s dtype, the position dtype by default)."""
    threads = threads_for(n)
    lib = _library(swaps)
    smem, shared = ctypes.c_longlong(), ctypes.c_int()
    code = lib.seq_sweep_plan(
        int(dtype == torch.float64), int((ledger or dtype) == torch.float64), int(swaps), int(bias), d, n, S, M,
        threads, ctypes.byref(smem), ctypes.byref(shared),
    )
    _raise_on(lib, code, "seq_sweep_plan")
    return threads, smem.value, bool(shared.value)


def _check(position, energy, want):
    """Shapes, dtypes, devices and contiguity of a launch's inputs; `want`
    maps each name to (tensor or None, shape, dtype), None for one the
    launch goes without."""
    dt = position.dtype
    if position.shape[-1] not in (2, 3):
        raise ValueError(f"position {tuple(position.shape)}: need d in (2, 3)")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the sequential sweep takes float32 or float64 positions, not {dt}")
    if energy.dtype not in (dt, torch.float64):
        raise TypeError(f"the ledger is {energy.dtype}: it takes {dt} or float64")
    for name, (t, shape, dtype) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.device != position.device:
            raise ValueError(f"{name} is on {t.device}, expected {position.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def sweep(position, species, box, temperature, energy, table, sigma, move, pick, normal, u, *, moves=None,
          theta=None, r1=None, r2=None, gumbel=None, kinds=None):
    """Run every step of one sequential sweep of every chain.

    Takes position [B, N, d] (float32 or float64), species [B, N] int64,
    box [B, d], temperature [B], the ledger energy [B] (the position dtype or
    float64), the packed pair table [9, S, S] (pack_table), each move's
    sigma per chain [B, M] (any positive value for a swap), and the sweep's
    draws: move and pick [B, steps] int64, normal [B, steps, d], u [B, steps]
    in (0, 1]; all but energy in the position dtype. A pool with swaps also
    takes its move table `moves` [M, 3] int32 (move_table), and the draws r1,
    r2 [B, steps] int64 (ranks within the chosen DoubleUniform swap's two
    populations) where it has a DoubleUniform swap; one with an EnergyBias
    swap also takes theta1 and theta2 per chain and move `theta` [B, M, 2]
    and the Gumbel noise `gumbel` [B, steps, 2, N], in the position dtype.
    pick and normal may be None in a pool without displacements. Returns
    position [B, N, d], species [B, N] (the input where the pool has no
    swap), energy [B] and accepts [B, steps] int64 (1 where the step was
    accepted); the inputs are not changed. `kinds` is the sorted tuple of the
    potential kinds in the table (models/tables.py::kinds_present) and picks
    the kernel's variant; None reads it from `table`, a host sync per call. A
    block of threads_for(N) threads runs each chain. Tensors on any device
    but a CUDA card raise."""
    if position.device.type != "cuda":
        raise ValueError(f"the sequential sweep kernel runs on a CUDA card, not {position.device}")
    if not position.is_contiguous():
        raise ValueError("position must be contiguous")
    B, n, d = position.shape
    S, M = table.shape[-1], sigma.shape[-1]
    dt = position.dtype
    steps = move.shape[1] if move.dim() == 2 else -1
    swaps, bias = moves is not None, gumbel is not None
    if S > 127:
        raise ValueError(f"the sequential sweep keeps species in int8: at most 127 species, got {S}")
    if (pick is None or normal is None) and not swaps:
        raise ValueError("a pool of displacements needs the pick and normal draws")
    if (r1 is None) != (r2 is None) or (bias and not swaps) or (bias != (theta is not None)):
        raise ValueError("r1 and r2 come together; theta and gumbel come together, with moves")
    _check(position, energy, {
        "species": (species, (B, n), torch.int64),
        "box": (box, (B, d), dt),
        "temperature": (temperature, (B,), dt),
        "energy": (energy, (B,), energy.dtype),
        "table": (table, (len(PAIR_FIELDS), S, S), dt),
        "sigma": (sigma, (B, M), dt),
        "move": (move, (B, steps), torch.int64),
        "pick": (pick, (B, steps), torch.int64),
        "normal": (normal, (B, steps, d), dt),
        "u": (u, (B, steps), dt),
        "moves": (moves, (M, 3), torch.int32),
        "theta": (theta, (B, M, 2), dt),
        "r1": (r1, (B, steps), torch.int64),
        "r2": (r2, (B, steps), torch.int64),
        "gumbel": (gumbel, (B, steps, 2, n), dt),
    })
    dev = position.device
    pos_out = torch.empty_like(position)
    species_out = torch.empty_like(species) if swaps else species
    energy_out = torch.empty_like(energy)
    accepts = torch.empty((B, steps), dtype=torch.int64, device=dev)
    scratch = torch.empty((B, 2, n), dtype=energy.dtype, device=dev) if bias else None
    variant = kernel_variant(table_kinds(table) if kinds is None else kinds)
    lib = _library(swaps)
    with torch.cuda.device(dev):  # the runtime launches on its current device
        code = lib.seq_sweep(
            int(dt == torch.float64), int(energy.dtype == torch.float64), d, variant, int(swaps), int(bias),
            position.data_ptr(), species.data_ptr(), box.data_ptr(), temperature.data_ptr(), energy.data_ptr(),
            table.data_ptr(), sigma.data_ptr(), move.data_ptr(), _ptr(pick), _ptr(normal), u.data_ptr(),
            _ptr(moves), _ptr(theta), _ptr(r1), _ptr(r2), _ptr(gumbel),
            B, n, S, M, steps, threads_for(n),
            pos_out.data_ptr(), _ptr(species_out) if swaps else None, energy_out.data_ptr(), accepts.data_ptr(),
            _ptr(scratch), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, code, "seq_sweep launch")
    tracing.count("seq_cuda.launches")
    tracing.count("seq_cuda.steps", B * steps)
    if swaps:
        tracing.count("seq_cuda.swap_launches")
    return pos_out, species_out, energy_out, accepts

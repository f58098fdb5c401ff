"""Sequential displacement sweep on the card: wrapper of the CUDA kernel
csrc/seq_disp_sweep.cu. Each launch adds one to the counter
`seq_cuda.launches` and its chains times steps to `seq_cuda.steps`
(tracing.counters()); each nvcc build is one call of the `setup.kernel_build`
phase (tracing.totals()).

Replaces no TPU kernel: the JAX package runs the sequential step as XLA ops.
One launch runs every step of one sweep of every chain, for a pool whose
every move is a Gaussian displacement, with the dense ΔE, on an atomic
system (moves/kernel.py::takes_sweep_kernel decides). Per chain and step, in
order, on the sweep's draws: particle i = pick, δ = σ[move] · normal,
ΔE = Σ over j ≠ i of u(r²_new) − u(r²_old) with the minimum image in the
chain's box, computed in the position dtype; accept iff ΔE is finite and
log u < (−ΔE / T + log q) − log q (log q of the symmetric Gaussian, as the
plain step adds and subtracts it); on accept x_i moves, unwrapped, and the
ledger adds ΔE. A ΔE with an infinite term rejects, as in the plain step,
where e_i + 0 · e_i is NaN then; so an accepted displacement always books
its ΔE.

What bounds it on an H100: the latency of the chain of dependent steps. A
step needs about 30 N operations and a few hundred bytes, so the card's
rates allow far less than a microsecond; each step ends in a reduction
over the chain's particles that the next step waits for. The design: one
block per chain for the whole sweep, its positions and species in shared
memory where they fit (else read through L2), one block barrier and two
warp butterflies per step, the next step's draws loaded during the current
one (the source's header has the details). No atomics, a fixed reduction
order: a launch is bitwise reproducible.

The wrapper takes CUDA tensors only and never falls back: the plain version
is the plain step of moves/kernel.py, which every CPU sweep runs
(`build_sweep_fn(...).plain` runs it on card tensors too). The kernel is
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
MAX_THREADS = 512


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path = build_library(SOURCE)
    with tracing.phase("setup.kernel_load"):
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seq_disp_sweep.argtypes = [i] * 4 + [p] * 11 + [i] * 6 + [p] * 4
        lib.seq_disp_sweep.restype = i
        lib.seq_disp_sweep_plan.argtypes = [i] * 6 + [p, p]
        lib.seq_disp_sweep_plan.restype = i
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


def launch_plan(dtype, d: int, n: int, S: int, M: int):
    """The launcher's choice for these shapes on the current card: (threads
    per block, dynamic shared memory bytes of a block, whether the chain's
    positions live in shared memory (else they are read through L2))."""
    threads = threads_for(n)
    lib = _library()
    smem, shared = ctypes.c_longlong(), ctypes.c_int()
    code = lib.seq_disp_sweep_plan(
        int(dtype == torch.float64), d, n, S, M, threads, ctypes.byref(smem), ctypes.byref(shared)
    )
    _raise_on(lib, code, "seq_disp_sweep_plan")
    return threads, smem.value, bool(shared.value)


def _check(position, species, box, temperature, energy, table, sigma, move, pick, normal, u):
    B, n, d = position.shape
    steps = move.shape[1] if move.dim() == 2 else -1
    S, M = table.shape[-1], sigma.shape[-1]
    dt = position.dtype
    if d not in (2, 3):
        raise ValueError(f"position {tuple(position.shape)}: need d in (2, 3)")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"disp_sweep takes float32 or float64 positions, not {dt}")
    if energy.dtype not in (dt, torch.float64):
        raise TypeError(f"the ledger is {energy.dtype}: it takes {dt} or float64")
    if S > 127:
        raise ValueError(f"disp_sweep keeps species in int8: at most 127 species, got {S}")
    want = {
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
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.device != position.device:
            raise ValueError(f"{name} is on {t.device}, expected {position.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not position.is_contiguous():
        raise ValueError("position must be contiguous")
    return B, n, d, S, M, steps


def disp_sweep(position, species, box, temperature, energy, table, sigma, move, pick, normal, u, *, kinds=None):
    """Run every step of one sequential displacement sweep of every chain.

    Takes position [B, N, d] (float32 or float64), species [B, N] int64,
    box [B, d], temperature [B], the ledger energy [B] (the position dtype or
    float64), the packed pair table [9, S, S] (pack_table), each move's
    sigma per chain [B, M], and the sweep's draws: move and pick [B, steps]
    int64, normal [B, steps, d], u [B, steps] in (0, 1]; all but energy in
    the position dtype. Returns position [B, N, d], energy [B] and accepts
    [B, steps] int64 (1 where the step was accepted); the inputs are not
    changed. `kinds` is the sorted tuple of the potential kinds in the table
    (models/tables.py::kinds_present) and picks the kernel's variant; None
    reads it from `table`, a host sync per call. A block of threads_for(N)
    threads runs each chain. Tensors on any device but a CUDA card raise."""
    if position.device.type != "cuda":
        raise ValueError(f"disp_sweep runs on a CUDA card, not {position.device}")
    B, n, d, S, M, steps = _check(position, species, box, temperature, energy, table, sigma, move, pick, normal, u)
    dev = position.device
    pos_out = torch.empty_like(position)
    energy_out = torch.empty_like(energy)
    accepts = torch.empty((B, steps), dtype=torch.int64, device=dev)
    variant = kernel_variant(table_kinds(table) if kinds is None else kinds)
    lib = _library()
    with torch.cuda.device(dev):  # the runtime launches on its current device
        code = lib.seq_disp_sweep(
            int(position.dtype == torch.float64), int(energy.dtype == torch.float64), d, variant,
            position.data_ptr(), species.data_ptr(), box.data_ptr(), temperature.data_ptr(),
            energy.data_ptr(), table.data_ptr(), sigma.data_ptr(), move.data_ptr(), pick.data_ptr(),
            normal.data_ptr(), u.data_ptr(),
            B, n, S, M, steps, threads_for(n),
            pos_out.data_ptr(), energy_out.data_ptr(), accepts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, code, "seq_disp_sweep launch")
    tracing.count("seq_cuda.launches")
    tracing.count("seq_cuda.steps", B * steps)
    return pos_out, energy_out, accepts


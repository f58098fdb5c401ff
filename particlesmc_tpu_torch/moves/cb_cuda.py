"""Checkerboard displacement substep on the card: wrapper and plain version
of the CUDA kernel csrc/cb_disp_substep.cu. Each launch adds one to the
counter `cb_cuda.launches` (tracing.counters()); each nvcc build is one
call of the `setup.kernel_build` phase (tracing.totals()).

Replaces the TPU kernel `particlesmc_tpu/moves/cb_pallas.py::build_disp_substep`.
For every chain and every active cell of one colour, it runs the `inner`
sequential Metropolis sub-moves of the substep against the centre lanes and
the 3^d - 1 image-corrected neighbour cells: pick lane floor(u * occ),
propose x + dl, reject an empty cell or a proposal outside [lo, hi),
ΔE = Σ over the valid non-mover lanes of u(r²_new) − u(r²_old), accept if
ΔE < thr (thr = −T log u), book ΔE if finite, move the lane.

What bounds it on an H100: instructions. A launch reads each input once
(about B·A·LP·(d+1) elements), but does about 8.5e9 operations on them at
the N = 10,000, 256-chain main path: for every valid non-mover lane of an
in-cell proposal two r², the cutoff tests and, within the cutoff, the
potential's body. Each sub-move depends on the one before, so the latency
of a sub-move's steps counts too.
The design gives each (chain, cell) one warp for the whole inner loop, four
cells to a block. The warp copies its cell to shared memory once: centre
lanes verbatim, neighbour lanes compacted to the valid ones (about 60% of
them at the bench point), its draws for every sub-move. The inner loop reads
no device memory and crosses no block barrier: a warp-wide shuffle sum
replaces the block reduction. The potential is specialised at compile time
on the kinds in the table (`kinds`, from models/tables.py::kinds_present):
one variant each for LJ, smooth LJ and inverse power, and a generic one for
any mix; it reads the mover's row of the table from shared memory and takes
sigma²/r² as sigma² times a reciprocal.

The wrapper launches the kernel for CUDA tensors and uses the plain version
only for CPU tensors; it never falls back. The kernel is built with nvcc at
first use from the sources in this package, into `particlesmc_tpu_torch/_build/`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import tracing
from ..models.potentials import (
    KIND_INVERSE_POWER,
    KIND_LENNARD_JONES,
    KIND_SMOOTH_LJ,
    PAIR_FIELDS,
    pair_potential,
)
from ..models.tables import PairTable, _Params

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cb_disp_substep.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def pack_table(table: PairTable, dtype) -> torch.Tensor:
    """The kernel's pair table: [9, S, S] in `dtype`, fields in PAIR_FIELDS
    order (kind and ipl_n stored as exact small floats)."""
    return torch.stack([getattr(table, f).to(dtype) for f in PAIR_FIELDS]).contiguous()


# the kernel's potential variants: a table of one kind gets that kind's
# variant, any other table the generic one
GENERIC_VARIANT = 0
_KIND_VARIANTS = {
    (KIND_INVERSE_POWER,): KIND_INVERSE_POWER,
    (KIND_LENNARD_JONES,): KIND_LENNARD_JONES,
    (KIND_SMOOTH_LJ,): KIND_SMOOTH_LJ,
}


def kernel_variant(kinds) -> int:
    """The kernel's potential variant for a sorted tuple of the kinds present
    in the table (models/tables.py::kinds_present)."""
    return _KIND_VARIANTS.get(tuple(kinds), GENERIC_VARIANT)


def table_kinds(table: torch.Tensor):
    """Sorted tuple of the kinds in a packed table [9, S, S]. Reads the table
    on the host: a caller that launches many times computes it once."""
    return tuple(sorted({int(k) for k in table[PAIR_FIELDS.index("kind")].reshape(-1).tolist()}))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def build_library(source: Path = SOURCE) -> Path:
    """Compile a CUDA source of this package (csrc/cb_disp_substep.cu by
    default) into a shared library lib<stem>.so keyed on a hash of the source,
    the headers of csrc/ it may include, and the flags; an existing build is
    reused. The nvcc log (ptxas register and shared-memory report) is kept
    beside it."""
    src = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.tmp"
    with tracing.phase("setup.kernel_build"):
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path = build_library()
    with tracing.phase("setup.kernel_load"):
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cb_disp_substep.argtypes = [i, i] + [p] * 8 + [i] * 7 + [p] * 4
        lib.cb_disp_substep.restype = i
        lib.cb_disp_substep_plan.argtypes = [i] * 5 + [p, p]
        lib.cb_disp_substep_plan.restype = i
        lib.cb_error_string.argtypes = [i]
        lib.cb_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what} failed: {lib.cb_error_string(code).decode()}")


def launch_plan(dtype, d: int, S: int, LP: int, inner: int):
    """The launcher's choice for these shapes on the current card: (cells per
    block, dynamic shared memory bytes of a block). `LP` is the lanes of a
    cell, centre and neighbour (cap + K under disp_substep's `cap=`)."""
    lib = _library()
    cpb, smem = ctypes.c_int(), ctypes.c_longlong()
    code = lib.cb_disp_substep_plan(
        int(dtype == torch.float64), d, S, LP, inner, ctypes.byref(cpb), ctypes.byref(smem)
    )
    _raise_on(lib, code, "cb_disp_substep_plan")
    return cpb.value, smem.value


def _lanes(LP: int, d: int, cap=None) -> int:
    """The centre lanes of LP lanes: `cap` when given (LP = cap + K, K >= 0
    neighbour lanes, as under candidate compaction), else LP / 3^d."""
    if cap is None:
        if LP % 3**d:
            raise ValueError(f"{LP} lanes: without cap=, LP must be 3^d * cap")
        return LP // 3**d
    if not 1 <= int(cap) <= LP:
        raise ValueError(f"cap = {cap} must lie in [1, LP = {LP}]")
    return int(cap)


def _check(packed_pos, packed_sp, up, dl, thr, lo, hi, table, cap=None):
    B, d, A, LP = packed_pos.shape
    inner = up.shape[1]
    S = table.shape[-1]
    want = {
        "packed_pos": (packed_pos, (B, d, A, LP)),
        "packed_sp": (packed_sp, (B, A, LP)),
        "up": (up, (B, inner, A)),
        "dl": (dl, (B, inner, d, A)),
        "thr": (thr, (B, inner, A)),
        "lo": (lo, (d, A)),
        "hi": (hi, (d, A)),
        "table": (table, (len(PAIR_FIELDS), S, S)),
    }
    if d not in (2, 3):
        raise ValueError(f"packed_pos {tuple(packed_pos.shape)}: need d in (2, 3)")
    cap = _lanes(LP, d, cap)
    if packed_pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"disp_substep takes float32 or float64, not {packed_pos.dtype}")
    if B > 65535:
        raise ValueError(f"disp_substep launches at most 65535 chains, got {B}")
    if S > 127:
        raise ValueError(f"disp_substep keeps species in int8: at most 127 species, got {S}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != packed_pos.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {packed_pos.dtype}")
        if t.device != packed_pos.device:
            raise ValueError(f"{name} is on {t.device}, expected {packed_pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, d, A, LP, inner, S, cap


def disp_substep(packed_pos, packed_sp, up, dl, thr, lo, hi, table, *, kinds=None, cap=None):
    """Run the `inner` displacement sub-moves of one colour substep.

    Takes packed_pos [B, d, A, LP], packed_sp [B, A, LP], up/thr
    [B, inner, A] (up in [0, 1)), dl [B, inner, d, A], lo/hi [d, A] and the
    packed pair table [9, S, S] (pack_table); returns centre [B, d, A, cap],
    booked [B, A] and acc [B, A, inner] (int32). `kinds` is the sorted tuple
    of the potential kinds in the table (models/tables.py::kinds_present) and
    picks the kernel's variant; None reads it from `table`, a host sync per
    call. `cap` gives the centre lanes when the neighbour lanes are not the
    3^d - 1 whole cells (LP = cap + K, the candidate compaction's layout);
    without it LP = 3^d * cap. CUDA tensors launch the kernel, CPU tensors
    run disp_substep_plain; anything else raises."""
    if packed_pos.device.type == "cpu":
        return disp_substep_plain(packed_pos, packed_sp, up, dl, thr, lo, hi, table, cap=cap)
    if packed_pos.device.type != "cuda":
        raise ValueError(f"disp_substep runs on cuda or cpu, not {packed_pos.device}")
    B, d, A, LP, inner, S, cap = _check(packed_pos, packed_sp, up, dl, thr, lo, hi, table, cap)
    dt = packed_pos.dtype
    dev = packed_pos.device
    centre = torch.empty((B, d, A, cap), dtype=dt, device=dev)
    booked = torch.empty((B, A), dtype=dt, device=dev)
    acc = torch.empty((B, A, inner), dtype=torch.int32, device=dev)
    variant = kernel_variant(table_kinds(table) if kinds is None else kinds)
    lib = _library()
    with torch.cuda.device(dev):  # the runtime launches on its current device
        code = lib.cb_disp_substep(
            int(dt == torch.float64), d,
            packed_pos.data_ptr(), packed_sp.data_ptr(), up.data_ptr(), dl.data_ptr(),
            thr.data_ptr(), lo.data_ptr(), hi.data_ptr(), table.data_ptr(),
            S, B, A, LP, cap, inner, variant,
            centre.data_ptr(), booked.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, code, "cb_disp_substep launch")
    tracing.count("cb_cuda.launches")
    return centre, booked, acc


def disp_substep_plain(packed_pos, packed_sp, up, dl, thr, lo, hi, table, *, cap=None):
    """The same function as disp_substep in plain PyTorch: a loop over the
    `inner` sub-moves with masked reductions over [B, A, LP]."""
    B, d, A, LP = packed_pos.shape
    inner = up.shape[1]
    S = table.shape[-1]
    cap = _lanes(LP, d, cap)
    dt = packed_pos.dtype
    dev = packed_pos.device
    pos = packed_pos.clone()
    valid_sp = packed_sp >= 0
    pair_row = torch.clamp_min(packed_sp, 0).long()  # neighbour species index
    occ = valid_sp[..., :cap].sum(dim=-1)  # [B, A]
    occupied = occ > 0
    lanes = torch.arange(LP, device=dev)
    flat = table.reshape(len(PAIR_FIELDS), S * S)
    int_fields = ("kind", "ipl_n")
    booked = torch.zeros((B, A), dtype=dt, device=dev)
    acc = torch.empty((B, A, inner), dtype=torch.int32, device=dev)
    for k in range(inner):
        r = torch.floor(up[:, k] * occ.to(dt)).long().clamp(0, LP - 1)  # [B, A]
        pick = lanes == r[..., None]  # [B, A, LP]
        x_a = torch.gather(pos, 3, r[:, None, :, None].expand(B, d, A, 1))[..., 0]
        s_a = torch.gather(packed_sp, 2, r[..., None])[..., 0]
        x_new = x_a + dl[:, k]  # [B, d, A]
        in_cell = occupied & ((x_new >= lo) & (x_new < hi)).all(dim=1)
        pair = torch.clamp_min(s_a, 0).long()[..., None] * S + pair_row
        p = _Params(
            **{
                f: flat[i][pair].to(torch.int32) if f in int_fields else flat[i][pair]
                for i, f in enumerate(PAIR_FIELDS)
            }
        )
        r2o = torch.zeros(pair.shape, dtype=dt, device=dev)
        r2n = torch.zeros(pair.shape, dtype=dt, device=dev)
        for j in range(d):
            dxo = pos[:, j] - x_a[:, j, :, None]
            dxn = pos[:, j] - x_new[:, j, :, None]
            r2o = r2o + dxo * dxo
            r2n = r2n + dxn * dxn
        du = pair_potential(r2n, p) - pair_potential(r2o, p)
        de = torch.sum(torch.where(valid_sp & ~pick, du, torch.zeros_like(du)), dim=-1)
        accept = (de < thr[:, k]) & in_cell
        booked = booked + torch.where(accept & torch.isfinite(de), de, torch.zeros_like(de))
        moved = (pick & accept[..., None])[:, None]  # [B, 1, A, LP]
        pos = torch.where(moved, x_new[..., None], pos)
        acc[..., k] = accept.to(torch.int32)
    return pos[..., :cap].contiguous(), booked, acc

"""Smoke test of particlesmc_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout (printing ptxas's
registers and spills of each instantiation), holds it against its plain
PyTorch version at the shapes of the main path (the potential variant for
the table's kinds, and the generic variant), then drives the main path
through the two entry points a user calls: the library (N = 10,000
Kob-Andersen LJ in 3D, 256 chains, mixed precision, 48 sub-moves per cell
and colour, 16 sweeps per rebin) and the TOML CLI on a shortened copy of
examples/movie/params.toml (2D JBB, N = 1290, float64), and holds the kernel
against its plain version a second time at the CLI path's shapes, on the CLI
run's final state. Then the other checkerboard paths, each with its own
assertions and a profiled block split into kernel, non-kernel sub-moves,
other glue and idle:
- cli_swap: the lj-mixture dense point (N = 4096, x = 0.5, T = 1.2183,
  rho = 0.8, rcut 4, cap 192, 8 chains, mixed precision) through the CLI
  with Displacement + DiscreteSwap/DoubleUniform, then the kernel against
  its plain version at that path's shapes (192 centre lanes);
- library_energy_bias: the pgmc-ka2d system (2D JBB, N = 1290, 10 chains,
  float64) with Displacement + two EnergyBias swaps at fixed theta, then
  the kernel against its plain version at that path's shapes (every run
  length its schedule launches) and one sweep of the mixed pool through
  the kernel against the same sweep through the plain version;
- cli_smart: examples/movie/params.toml with SmartGaussian (no kernel);
- library_molecular: molecule.npz (1000 trimers, N = 3000) cloned to 16
  chains with Displacement + MoleculeFlip (no kernel).
Then the sequential kernel (no kernel launch), each path with a traced
16-step sweep for its device launches and stream synchronisations per step:
- library_sequential: benchmarks/scenarios.py's large-2d-dense (2D JBB,
  N = 1000, dense ΔE) and larger-ss-3d-cell (3D BHHP, N = 3000, cell list
  through force_cells), 64 chains, mixed precision, one warm-up and one
  timed sweep each; then one float64 sweep at N = 64 on the card against
  the same sweep on the CPU on the same draws;
- library_sequential_swap: large-2d-dense, 8 chains, one timed sweep of
  Displacement + DoubleUniform + EnergyBias swaps after a 16-step warm-up;
- library_sequential_molecular: molecule.npz x 4 chains, one timed sweep of
  Displacement + MoleculeFlip after a 16-step warm-up;
- cli_tempering: examples/movie on a 4-rung temperature ladder through the
  CLI, sequential (ReplicaExchange and AdaptiveSigma every step) and
  checkerboard (ReplicaExchange every 8 steps, kernel launches counted),
  then the kernel against its plain version at the tempered run's shapes
  (4 chains, each with its own temperature's thresholds).
Then PGMC and checkpoints:
- library_pgmc: examples/pgmc-ka2d/run-study.py's configuration (2D JBB,
  N = 1290, 10 chains, f64) through Simulation on the checkerboard backend,
  Displacement + two EnergyBias swaps learned from theta = 0 (VPG), 40
  sweeps with an estimate, an update and a parameters row every 10; then
  one estimate() on the card against the CPU on the same actions, the
  estimator's milliseconds, launches and synchronisations per call, and
  the kernel against its plain version at this path's shapes with the
  learned sigma and theta;
- library_pgmc_sequential: the reference's test/pgmc_ka2d.jl scenario (N =
  43, 10 chains, the sequential dense kernel, VPG + BLANPG, an estimate
  every sweep, an update every 2), 20 sweeps (no kernel launch);
- checkpoint: examples/movie through the CLI, 64 steps with a checkpoint at
  32 and a --resume from it, and large-2d-dense on the sequential kernel (8
  chains, 4 sweeps, a checkpoint at 2): each resumed run ends bitwise where
  the straight-through run ends.
Then the observables and the last checkerboard paths:
- analysis: the virial pressure and g(r) of 8 of the library path's final
  chains on the card against the CPU, and a 32-step examples/movie run
  through the CLI with profile_dir (a trace file) whose 16 stored frames
  give the MSD and F_s(k, t) on the card against the CPU;
- library_trim: the main path with trim = "auto" (512 neighbour lanes,
  LP 544), its kernel launches, compaction time and ledger, and the kernel
  against its plain version at the trimmed shapes;
- library_spatial: one KA-LJ system of N = 633,017 (a 32^3 grid) as 2 and 4
  slabs on the card against the unsharded run (bitwise in float64), with a
  DoubleUniform swap pool too, sweeps/s at P = 1, 2, 4, the halo exchange's
  device time, and the kernel against its plain version at a slab's shapes.
It then prints the launcher's cells per block and shared memory at each
kernel path's shapes. Every phase prints one JSON line, and a `wall_seconds`
line gives each phase's wall time; any failure raises and the exit code is
not 0. The last line is {"ok": true, "device": {...}}.
Without CUDA, or without the package beside it, the script fails before
printing a result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, outside the tensor cores) and HBM rate
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12

# the main path's state point: Kob-Andersen LJ, 3D, rho = 1.2, T = 1.0
N, DIM, DENSITY, TEMPERATURE = 10_000, 3, 1.2, 1.0
CHAINS, CAP, INNER, REBIN, SIGMA = 256, 32, 48, 16, 0.06
TIMED_BLOCKS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def _time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of `fn()` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def lattice_config(n, d=DIM, density=DENSITY, seed=0):
    """The benchmark's start: a slightly perturbed cubic lattice, 20% B."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per_dim = int(np.ceil(n ** (1 / d)))
    a = L / per_dim
    grid = np.stack(
        np.meshgrid(*[np.arange(per_dim) * a + a / 2] * d, indexing="ij"), -1
    ).reshape(-1, d)[:n]
    pos = grid + rng.uniform(-0.05 * a, 0.05 * a, (n, d))
    species = (rng.random(n) < 0.2).astype(np.int64) + 1
    return pos, species


# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit({
        "phase": "device", "kind": name, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return name, smi


VARIANT_NAMES = {0: "generic", 1: "inverse_power", 2: "lennard_jones", 3: "smooth_lj"}


def phase_build():
    from particlesmc_tpu_torch.moves import cb_cuda

    cached = any(cb_cuda.BUILD_ROOT.glob("*/libcb_disp_substep.so"))
    t0 = time.perf_counter()
    lib = cb_cuda.build_library()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    # registers and spills of each instantiation <dtype, d, variant>
    by_kernel, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"disp_substep_kernelI([fd])Li(\d)ELi(\d)E", ln)
        if m and ("Compiling entry" in ln or "Function properties" in ln):
            dt = "f32" if m.group(1) == "f" else "f64"
            current = f"{dt} d={m.group(2)} {VARIANT_NAMES[int(m.group(3))]}"
        elif current and ("registers" in ln or "spill" in ln):
            by_kernel.setdefault(current, []).append(ln.split(":", 1)[-1].strip())
    emit({"phase": "build", "seconds": build_s, "cached": cached, "library": str(lib.relative_to(ROOT)),
          "ptxas": ptxas, "ptxas_by_kernel": by_kernel})


def bench_system(device, seed=0):
    """The library path's start in float64: `CHAINS` perturbed lattices of
    N = 10,000 KA-LJ, each with its own jitter from a fixed seed."""
    from particlesmc_tpu_torch.core.state import make_system

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pos, species = lattice_config(N)
    st = make_system(pos, species, DENSITY, TEMPERATURE, dtype=torch.float64, device=device)
    st = st.repeat(CHAINS)
    a = float(st.box[0, 0]) / int(np.ceil(N ** (1 / DIM)))
    jitter = (torch.rand(st.position.shape, generator=g, dtype=torch.float64, device=device) - 0.5)
    return st.replace(position=st.position + jitter * 0.1 * a)


def substep_inputs(st, table, spec, inner, sigma, seed=1):
    """Kernel inputs as the main path gives them, in the dtype of `st`: the
    first colour of the binned, padded grid of `st` under random grid shifts,
    with draws from a fixed seed."""
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    dtype, device = st.position.dtype, st.position.device
    B, d, A = st.n_chains, st.dim, spec.n_active
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=dtype, device=device)

    planes, _, _, _ = CB.rebin(st, spec, rand(B, d) * st.box)
    padded = CB.pad_grid(planes, spec, st.box)
    c = CB.colours(d)[0]
    packed_pos, packed_sp, _ = CB.extract_colour(padded, spec, c)
    lo, hi = CB.cell_bounds(spec, st.box[0], c)
    up = rand(B, inner, A) * (1.0 - 1e-7)
    dl = torch.randn((B, inner, d, A), generator=g, dtype=dtype, device=device) * sigma
    u = torch.clamp_min(rand(B, inner, A), torch.finfo(dtype).tiny)
    thr = -st.temperature.reshape(B, 1, 1) * torch.log(u)
    return packed_pos, packed_sp, up, dl, thr, lo, hi, cb_cuda.pack_table(table, dtype)


def body_ops(tab):
    """[S, S] operations of the pair potential past its cutoff compare, by
    the pair's kind: clamp, divide, x^3 (2), x^6 (1), subtract and times
    eps4 for the LJ core (7); minus the shift (LJ, kind 2: 8); the
    smoothing polynomial, times eps4 and the add (smooth LJ, kind 3: 13);
    clamp, divide, sqrt, the square-and-multiply chain, times eps and minus
    the shift (inverse power, kind 1). Kind 0 has no body."""
    kind = tab[0].long().cpu()
    n = tab[3].long().cpu()
    out = torch.zeros(kind.shape, dtype=torch.int64)
    for (i, j), k in np.ndenumerate(kind.numpy()):
        if k == 1:
            nij = int(n[i, j])
            out[i, j] = 5 + (nij.bit_length() - 1) + (bin(nij).count("1") - 1)
        elif k in (2, 3):
            out[i, j] = {2: 8, 3: 13}[int(k)]
    return out.to(tab.device)


def needed_ops(args, acc, cap=None):
    """Operations the function needs on these inputs, replaying the sub-moves
    with the accepts `acc` [B, A, inner]. Only a sub-move of an occupied cell
    whose proposal stays inside the cell needs its energy change; it needs,
    for every valid non-mover lane, two r^2 (3d - 1 each), two cutoff
    compares, the du subtract and its accumulate, and the potential's body
    (body_ops) for each of r^2_old and r^2_new that lies within the pair's
    cutoff.

    Also returns what the kernel's design does with these inputs: a warp
    walks the centre lanes and the compacted valid neighbour lanes, 32 lanes
    a pass, two passes an iteration, and a pass runs the potential's body
    when one of its lanes lies within the mover's row's largest cutoff."""
    packed_pos, packed_sp, up, dl, _, lo, hi, tab = args
    B, d, A, LP = packed_pos.shape
    inner = up.shape[1]
    cap = LP // 3**d if cap is None else cap  # cap= : compacted lanes, LP = cap + K
    S = tab.shape[-1]
    dev = packed_pos.device
    body = body_ops(tab).reshape(-1)
    rcut2 = tab[4].reshape(-1)
    row_max = tab[4].amax(dim=-1)  # [S]
    live = (tab[0] != 0).reshape(-1)
    pos = packed_pos.clone()
    valid = packed_sp >= 0
    sp = torch.clamp_min(packed_sp, 0).long()
    occ = valid[..., :cap].sum(dim=-1)
    lanes = torch.arange(LP, device=dev)
    # each lane's position in the kernel's compacted order, and its pass
    nb_valid = valid[..., cap:].long()
    packed_idx = torch.cat([lanes[:cap].expand(B, A, cap), cap + torch.cumsum(nb_valid, -1) - 1], -1)
    pass_of = packed_idx // 32
    passes_per_cell = 2 * -(-(cap + nb_valid.sum(-1)) // 64)  # [B, A]
    per_lane = 2 * (3 * d - 1) + 2 + 2
    ops = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros(5, dtype=torch.int64, device=dev)  # sub-moves, passes, body passes, lanes, in range
    for k in range(inner):
        r = torch.floor(up[:, k] * occ.to(pos.dtype)).long().clamp(0, LP - 1)  # [B, A]
        x_a = torch.gather(pos, 3, r[:, None, :, None].expand(B, d, A, 1))[..., 0]
        x_new = x_a + dl[:, k]
        in_cell = (occ > 0) & ((x_new >= lo) & (x_new < hi)).all(dim=1)
        pick = lanes == r[..., None]
        need = valid & ~pick & in_cell[..., None]
        s_a = torch.gather(sp, 2, r[..., None])
        pair = s_a * S + sp
        r2o = ((pos - x_a[..., None]) ** 2).sum(dim=1)
        r2n = ((pos - x_new[..., None]) ** 2).sum(dim=1)
        near = need & live[pair]
        in_o = near & (r2o <= rcut2[pair])
        in_n = near & (r2n <= rcut2[pair])
        ops += per_lane * need.sum()
        ops += (body[pair] * (in_o.long() + in_n.long())).sum()
        rm = row_max[s_a]
        enter = (need & ((r2o <= rm) | (r2n <= rm))).long()
        body_pass = torch.zeros((B, A, LP // 32 + 2), dtype=torch.int64, device=dev)
        body_pass.scatter_reduce_(2, pass_of, enter, "amax")
        counts += torch.stack([
            in_cell.sum(), (passes_per_cell * in_cell).sum(), body_pass.sum(),
            2 * need.sum(), in_o.sum() + in_n.sum(),
        ])
        moved = (pick & acc[..., k].bool()[..., None])[:, None]
        pos = torch.where(moved, x_new[..., None], pos)
    sub_moves, passes, body_passes, pair_terms, in_range = (int(c) for c in counts)
    design = {
        "in_cell_sub_moves": sub_moves,
        "passes_per_sub_move": passes / max(1, sub_moves),
        "body_pass_share": body_passes / max(1, passes),
        "pair_terms_in_range_share": in_range / max(1, pair_terms),
    }
    return float(ops), design


def bound_ms(args, outs, dtype, cap=None):
    """Least time the card could take: the larger of the bytes moved (each
    input read once, each output written once) over the HBM rate and the
    operations these inputs need (needed_ops) over the peak rate of their
    type."""
    ops, design = needed_ops(args, outs[2], cap)
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, design


# booked ΔE of a (chain, cell): kernel against plain version, relative to
# max(1, |plain|) (energies are O(1) in units of epsilon). In float32 the
# sum order alone moves it by a few 1e-5 at the library path's shapes.
BOOKED_RTOL = {torch.float64: 1e-12, torch.float32: 5e-4}


def compare(args, kinds, time_plain=True, cap=None):
    """The kernel's variant for `kinds` against its plain version on `args`
    (`cap`: the centre lanes of compacted lanes, LP = cap + K): asserts
    agreement and returns the errors, both times (the plain one only if
    `time_plain`) and the bound."""
    from particlesmc_tpu_torch.moves import cb_cuda

    dtype = args[0].dtype
    lanes = {} if cap is None else {"cap": cap}
    k_out = cb_cuda.disp_substep(*args, kinds=kinds, **lanes)
    p_out = cb_cuda.disp_substep_plain(*args, **lanes)
    torch.cuda.synchronize()
    acc_k = k_out[2].sum(dim=-1)
    acc_p = p_out[2].sum(dim=-1)
    same = acc_k == acc_p  # [B, A]
    differ_frac = 1.0 - float(same.float().mean())
    err = (k_out[0] - p_out[0]).abs().amax(dim=(1, 3))  # [B, A]
    max_err = float(torch.where(same, err, torch.zeros_like(err)).max())
    b_err = (k_out[1] - p_out[1]).abs()
    b_rel = b_err / torch.clamp_min(p_out[1].abs(), 1.0)
    booked_err = float(torch.where(same, b_err, torch.zeros_like(b_err)).max())
    booked_rel = float(torch.where(same, b_rel, torch.zeros_like(b_rel)).max())
    n_acc = int(acc_k.sum())
    if dtype == torch.float64:
        assert differ_frac == 0.0, f"f64 accept counts differ in {differ_frac:.4%} of cells"
        assert max_err <= 1e-9, f"f64 positions differ by {max_err}"
    else:
        assert differ_frac <= 1e-3, f"f32 accept counts differ in {differ_frac:.4%} of cells"
        assert max_err <= 1e-5, f"f32 positions differ by {max_err}"
    assert booked_rel <= BOOKED_RTOL[dtype], f"booked energy differs by {booked_rel} relative"
    assert n_acc > 0, "no sub-move was accepted"
    kernel_ms = _time_ms(lambda: cb_cuda.disp_substep(*args, kinds=kinds, **lanes), runs=20, warmup=3)
    plain_ms = _time_ms(lambda: cb_cuda.disp_substep_plain(*args, **lanes), runs=3) if time_plain else None
    b_ms, b_by, ops, design = bound_ms(args, k_out, dtype, cap)
    return dict(
        variant=VARIANT_NAMES[cb_cuda.kernel_variant(kinds)],
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ops=ops,
        max_abs_err=max_err, booked_max_abs_err=booked_err, booked_max_rel_err=booked_rel,
        accept_count_differ_frac=differ_frac, accepted=n_acc, lane_passes=design,
    )


def _shapes(args, cap=None):
    B, d, A, LP = args[0].shape
    return {"B": B, "d": d, "A": A, "cap": LP // 3**d if cap is None else cap, "LP": LP,
            "inner": args[2].shape[1], "S": args[-1].shape[-1]}


# every kind: the kernel's generic variant, which any table may take
ALL_KINDS = (0, 1, 2, 3)


def phase_kernel_vs_plain(device):
    """The kernel against its plain version at the library path's shapes,
    in float64 and float32: the variant for the table's kinds, and the
    generic variant."""
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    st = bench_system(device)
    table = T.KobAndersen(torch.float64, device)
    spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, N, CAP)
    args64 = substep_inputs(st, table, spec, INNER, SIGMA)
    kinds = T.kinds_present(table)
    cb_cuda.disp_substep.launches = 0
    out = {}
    for dtype in (torch.float64, torch.float32):
        key = "f64" if dtype == torch.float64 else "f32"
        args = tuple(t.to(dtype) for t in args64)
        out[key] = compare(args, kinds)
        out[key + "_generic"] = compare(args, ALL_KINDS, time_plain=False)
    launches = cb_cuda.disp_substep.launches
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    emit({"phase": "kernel_vs_plain", "path": "library", "shapes": _shapes(args64),
          "launches": launches, **out})
    return out, _shapes(args64)


def profile_block(run_block):
    """Device time of one block by torch.profiler: the kernel's, the
    sub-moves' that are not the kernel's (by their profiler range, per
    kind), the rest of the PyTorch glue's (which includes the candidate
    compaction's and the halo exchange's ranges, also given alone as
    `ranges_ms`), and the device's idle share of the block's span; and the
    host's stream synchronisations in it."""
    from torch.profiler import ProfilerActivity, profile

    from particlesmc_tpu_torch.moves.checkerboard import SUBMOVE_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_block()
        torch.cuda.synchronize()
    events = prof.events()
    # the ranges' own annotations on the device timeline are not device work
    evs = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("cb_")]
    assert evs, "the profiler saw no device activity"
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    span = (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) / 1e3
    busy = sum(by_name.values())
    kernel = sum(v for k, v in by_name.items() if "disp_substep_kernel" in k)
    submoves, ranges, other_ranges = {}, {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SUBMOVE_RANGE):
            kind = e.name[len(SUBMOVE_RANGE):]
            submoves[kind] = submoves.get(kind, 0.0) + e.device_time_total / 1e3
            ranges[kind] = ranges.get(kind, 0) + 1
        elif e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cb_"):
            other_ranges[e.name] = other_ranges.get(e.name, 0.0) + e.device_time_total / 1e3
    sub = sum(submoves.values())
    syncs = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    top = sorted(((v, k) for k, v in by_name.items() if "disp_substep_kernel" not in k), reverse=True)
    return {
        "span_ms": span, "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
        "kernel_ms": kernel, "kernel_share": kernel / span,
        "submove_ms": submoves, "submove_calls": ranges, "submove_share": sub / span,
        "glue_ms": busy - kernel - sub, "glue_share": (busy - kernel - sub) / span,
        "device_launches": len(evs), "stream_syncs": syncs, "top_glue": [[k[:80], v] for v, k in top[:5]],
        "ranges_ms": other_ranges,
    }


def gaussian_runs(pool, C, inner):
    """Lengths of the maximal runs of consecutive SimpleGaussian slots in
    each colour's row of the port's static slot schedule, counted here from
    the row's move indices (not by the port's own cut into kernel runs)."""
    from particlesmc_tpu_torch.moves import checkerboard as CB

    gauss = [mv.action == "displacement" and mv.policy == "gaussian" for mv in pool]
    runs = []
    for row in CB._slot_schedule(pool, C, inner).tolist():
        lengths, n = [], 0
        for m in row + [None]:
            if m is not None and gauss[m]:
                n += 1
            elif n:
                lengths.append(n)
                n = 0
        runs.append(lengths)
    return runs


def expected_launches(pool, spec, inner, sweepstep, sweeps):
    """Kernel launches of `sweeps` sweeps: one per run of consecutive
    SimpleGaussian slots of each colour, per round; and those runs."""
    C = 2**spec.d
    runs = gaussian_runs(pool, C, inner)
    rounds = max(1, -(-sweepstep // (spec.n_active * inner * C)))
    return sweeps * rounds * sum(len(r) for r in runs), runs


def phase_library(device):
    """The main path through the library entry points."""
    from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    pos, species = lattice_config(N)
    table = T.KobAndersen(torch.float32, device)
    st = make_system(pos, species, DENSITY, TEMPERATURE, dtype=torch.float32, device=device)
    st = initialize_energy(st, table, energy_dtype=torch.float64).repeat(CHAINS)
    spec = CB.make_cb_spec(st.box[0].double().cpu().numpy(), table.max_cutoff, N, CAP)
    pool = (MB.displacement(SIGMA),)
    params = MB.init_pool_params(pool, torch.float32, device)
    cb = CB.init_cb_state(st, spec, seed=0, n_moves=1)
    hs = CB.build_hyper_sweep_fn(spec, table, N, inner=INNER, sweeps=REBIN, pool=pool)
    C = 2**DIM
    rounds = max(1, -(-N // (spec.n_active * INNER * C)))

    cb = hs(cb, params)  # warm-up block
    torch.cuda.synchronize()
    att0 = int(cb.attempted.sum())
    acc0 = int(cb.accepted.sum())
    skip0 = int(cb.skipped.sum())
    pos0 = cb.system.position.clone()
    cb_cuda.disp_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED_BLOCKS):
        cb = hs(cb, params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cb_cuda.disp_substep.launches

    attempted = int(cb.attempted.sum()) - att0
    accepted = int(cb.accepted.sum()) - acc0
    skip_frac = (int(cb.skipped.sum()) - skip0) / (TIMED_BLOCKS * CHAINS)
    box = cb.system.box[:, None, :].double()
    dx = cb.system.position.double() - pos0.double()
    dx = dx - box * torch.round(dx / box)
    msd = float((dx * dx).sum(dim=-1).mean())
    acceptance = accepted / max(1, attempted)
    expected = REBIN * rounds * C * TIMED_BLOCKS
    assert launches == expected, f"{launches} kernel launches, expected {expected}"
    assert 0.0 < acceptance < 1.0, f"acceptance {acceptance}"

    profile = profile_block(lambda: hs(cb, params))

    table64 = table.astype(torch.float64)
    e_dense = total_energy_dense(
        cb.system.position[:2].double(), cb.system.species[:2], cb.system.box[:2].double(), table64
    )
    ledger = cb.system.energy[:2]
    gap = float((ledger - e_dense).abs().max()) / N
    assert bool(torch.isfinite(cb.system.position).all()), "non-finite positions"
    assert gap <= 1e-5, f"ledger differs from the dense recompute by {gap} per particle"
    emit({
        "phase": "library", "N": N, "chains": CHAINS, "precision": "mixed",
        "inner": INNER, "sweeps_per_rebin": REBIN, "cells": list(spec.ncells), "cap": spec.cap,
        "timed_blocks": TIMED_BLOCKS, "seconds": elapsed,
        "sweeps_per_s": attempted / N / elapsed,
        "block_ms": 1e3 * elapsed / TIMED_BLOCKS,
        "acceptance": acceptance, "msd_per_s": msd / elapsed, "skip_frac": skip_frac,
        "launches": launches, "launches_per_block": launches // TIMED_BLOCKS,
        "ledger_gap_per_particle": gap, "profiled_block": profile,
        "energy_per_particle": (ledger / N).tolist(),
    })
    return launches, cb, profile


def movie_params(tmp, steps, *edits):
    """examples/movie/params.toml written into `tmp` with the input frame's
    path, `steps` steps, its output under `tmp` and then `edits` (old, new)
    applied; returns the new file's path."""
    src = os.path.join(ROOT, "examples", "movie", "params.toml")
    with open(src) as f:
        text = f.read()
    frame = os.path.join(ROOT, "examples", "movie", "inputframe.exyz")
    for old, new in (
        ('config = "inputframe.exyz"', f'config = "{frame}"'),
        ("steps = 50000", f"steps = {steps}"),
        ('output_path = "./"', f'output_path = "{tmp}"'),
    ) + edits:
        assert old in text, f"{old!r} not in {src}"
        text = text.replace(old, new)
    params = os.path.join(tmp, "params.toml")
    with open(params, "w") as f:
        f.write(text)
    return params


def phase_cli(device):
    """The main path through the TOML CLI (run on the card by default): a
    shortened examples/movie run."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.moves import cb_cuda

    with tempfile.TemporaryDirectory() as tmp:
        steps = 200
        params = movie_params(
            tmp, steps,
            ("linear_interval = 500", "linear_interval = 50"),
            ("linear_interval = 1000", "linear_interval = 100"),
        )
        cb_cuda.disp_substep.launches = 0
        t0 = time.perf_counter()
        sim = cli.run_file(params)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = cb_cuda.disp_substep.launches
        energy = np.loadtxt(os.path.join(tmp, "chains", "1", "energy.dat"))
        accept = np.loadtxt(os.path.join(tmp, "moves", "1", "acceptance.dat"))
        assert os.path.exists(os.path.join(tmp, "chains", "1", "trajectory.exyz"))
    st = sim.mc.system
    assert st.position.device.type == device.type and st.position.dtype == torch.float64
    assert energy.shape == (steps // 50 + 1, 2) and np.isfinite(energy).all()
    assert accept.shape == (steps // 50 + 1, 2) and np.isfinite(accept).all()
    acceptance = float(accept[-1, 1])
    assert 0.0 < acceptance < 1.0, f"acceptance {acceptance}"
    e_dense = float(total_energy_dense(st.position, st.species, st.box, sim.chains.table)[0])
    ledger = float(st.energy[0])
    assert math.isclose(ledger, e_dense, rel_tol=1e-9), (ledger, e_dense)
    assert launches > 0, "the CLI run never launched the kernel"
    emit({
        "phase": "cli", "params": "examples/movie/params.toml (steps 200)", "N": st.n_particles,
        "precision": "f64", "cells": list(sim.cb_spec.ncells), "cap": sim.cb_spec.cap,
        "inner": sim.inner, "sweep_seconds": sim.sweep_seconds,
        "sweeps_per_s": steps / sim.sweep_seconds, "run_file_seconds": elapsed,
        "launches": launches, "acceptance": acceptance,
        "energy_per_particle": float(energy[-1, 1]), "ledger": ledger, "dense": e_dense,
    })
    return sim, launches


def phase_cli_kernel_vs_plain(sim, path="cli"):
    """The kernel against its plain version at a CLI path's shapes: the
    CLI run's final state (each chain's threshold from its own
    temperature), grid, pair table, `inner` and sigma, in its float64."""
    from particlesmc_tpu_torch.moves import cb_cuda

    from particlesmc_tpu_torch.models.tables import kinds_present

    sigma = dict(sim.pool[0].params)["sigma"]
    args = substep_inputs(sim.mc.system, sim.chains.table, sim.cb_spec, sim.inner, sigma)
    cb_cuda.disp_substep.launches = 0
    out = compare(args, kinds_present(sim.chains.table))
    launches = cb_cuda.disp_substep.launches
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    emit({"phase": "kernel_vs_plain", "path": path, "shapes": _shapes(args),
          "launches": launches, "f64": out})
    return out, _shapes(args)

# --- the lj-mixture dense point (examples/lj-mixture/run-validation.py) ----
# Lorentz-Berthelot-fitted pair parameters of the published mixture
LJMIX_EPS = {(1, 1): 1.0, (1, 2): 1.1523, (2, 2): 1.3702}
LJMIX_SIG = {(1, 1): 1.0, (1, 2): 1.0339, (2, 2): 1.0640}
LJMIX_N, LJMIX_X, LJMIX_T, LJMIX_RHO, LJMIX_RCUT = 4096, 0.5, 1.2183, 0.8, 4.0
LJMIX_SIGMA, LJMIX_CHAINS, LJMIX_STEPS = 0.05, 8, 64


def ljmix_write_config(n1, n2, L, path, rng):
    """Cubic-lattice EXYZ start, species shuffled over the sites."""
    n = n1 + n2
    per = round(n ** (1 / 3))
    assert per**3 == n, f"N={n} must be a cube"
    a = L / per
    species = np.array([1] * n1 + [2] * n2)
    rng.shuffle(species)
    rows = [f"{n}", f'Lattice="{L:.6f} 0.0 0.0 0.0 {L:.6f} 0.0 0.0 0.0 {L:.6f}" Properties=species:I:1:pos:R:3']
    k = 0
    for i in range(per):
        for j in range(per):
            for m in range(per):
                rows.append(f"{species[k]} {(i + 0.5) * a:.8f} {(j + 0.5) * a:.8f} {(m + 0.5) * a:.8f}")
                k += 1
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def ljmix_cap(rho, rcut, n):
    """Bucket capacity from the true cell geometry: 3x the mean occupancy of
    the (even-count) grid's cells at a dense point, 8x below rho = 0.35."""
    L = (n / rho) ** (1 / 3)
    nc = int(L / rcut)
    nc -= nc % 2
    side = L / max(nc, 2)
    factor = 8.0 if rho < 0.35 else 3.0
    return max(16, int(math.ceil(rho * side**3 * factor)))


def ljmix_write_params(workdir, cfg, steps):
    blocks = "".join(
        f'[model."{s1}-{s2}"]\nname = "LennardJones"\nepsilon = {eps}\nsigma = {LJMIX_SIG[(s1, s2)]}\n'
        f"rcut = {LJMIX_RCUT}\nshift_potential = false\n\n"
        for (s1, s2), eps in LJMIX_EPS.items()
    )
    toml = f"""
[system]
config = "{cfg}"
temperature = {LJMIX_T}
density = {LJMIX_RHO}
list_type = "LinkedList"
list_parameters = {{cap = {ljmix_cap(LJMIX_RHO, LJMIX_RCUT, LJMIX_N)}}}

[model]
{blocks}
[simulation]
type = "Metropolis"
nsim = {LJMIX_CHAINS}
steps = {steps}
seed = 42
precision = "mixed"
parallel_moves = true
verbose = false
output_path = "{workdir}"

[[simulation.move]]
action = "Displacement"
probability = 0.9
policy = "SimpleGaussian"
parameters = {{sigma = {LJMIX_SIGMA}}}

[[simulation.move]]
action = "DiscreteSwap"
probability = 0.1
policy = "DoubleUniform"
parameters = {{species = [1, 2]}}

[[simulation.output]]
algorithm = "StoreCallbacks"
callbacks = ["energy"]
scheduler_params = {{linear_interval = 16}}

[[simulation.output]]
algorithm = "StoreAcceptance"
dependencies = ["Metropolis"]
scheduler_params = {{linear_interval = {steps}}}
"""
    path = os.path.join(workdir, "params.toml")
    with open(path, "w") as f:
        f.write(toml)
    return path


def move_acceptance(mc):
    """Per-move acceptance over all chains, from the sampler's counters."""
    att = mc.attempted.sum(dim=0).double()
    return (mc.accepted.sum(dim=0).double() / torch.clamp_min(att, 1.0)).tolist()


def species_counts(species, n_species):
    return torch.stack([(species == s).sum(dim=-1) for s in range(n_species)], dim=-1)


def phase_cli_swap(device):
    """The lj-mixture dense point through the CLI: Displacement (p 0.9) +
    DiscreteSwap/DoubleUniform (p 0.1), then the kernel against its plain
    version at this path's shapes."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.models.tables import kinds_present
    from particlesmc_tpu_torch.moves import cb_cuda

    n1 = round(LJMIX_N * LJMIX_X)
    L = (LJMIX_N / LJMIX_RHO) ** (1 / 3)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "config.exyz")
        ljmix_write_config(n1, LJMIX_N - n1, L, cfg, np.random.default_rng(7))
        params = ljmix_write_params(tmp, cfg, LJMIX_STEPS)
        cb_cuda.disp_substep.launches = 0
        t0 = time.perf_counter()
        sim = cli.run_file(params)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = cb_cuda.disp_substep.launches
        energy = np.loadtxt(os.path.join(tmp, "chains", "1", "energy.dat"))
    st, spec = sim.mc.system, sim.cb_spec
    assert st.position.device.type == device.type and st.position.dtype == torch.float32
    assert spec.ncells == (4, 4, 4) and spec.cap == 192, (spec.ncells, spec.cap)
    counts = species_counts(st.species, 2)
    assert bool((counts == torch.tensor([n1, LJMIX_N - n1], device=counts.device)).all()), counts
    acceptance = move_acceptance(sim.mc)
    assert all(0.0 < a < 1.0 for a in acceptance), acceptance
    table64 = sim.chains.table.astype(torch.float64)
    e_dense = total_energy_dense(st.position.double(), st.species, st.box.double(), table64)
    gap = float((st.energy - e_dense).abs().max()) / LJMIX_N
    assert gap <= 1e-5, f"ledger differs from the dense recompute by {gap} per particle"
    expected, runs = expected_launches(sim.pool, spec, sim.inner, sim.sweepstep, LJMIX_STEPS)
    assert launches == expected > 0, f"{launches} kernel launches, expected {expected}"
    assert np.isfinite(energy).all()
    blocks = LJMIX_STEPS // sim.rebin_every
    # a one-sweep block for the trace: the profiler's parse of an 8-sweep
    # block's ~127,000 launches takes about a minute of host time
    profile = profile_block(lambda: sim._block(1)(sim.mc, sim.pool_params))
    emit({
        "phase": "cli_swap", "config": "lj-mixture dense point (examples/lj-mixture, x 0.5, T 1.2183, rho 0.8)",
        "N": LJMIX_N, "chains": st.n_chains, "precision": "mixed", "cells": list(spec.ncells),
        "cap": spec.cap, "inner": sim.inner, "sweeps_per_rebin": sim.rebin_every, "steps": LJMIX_STEPS,
        "sweep_seconds": sim.sweep_seconds, "run_file_seconds": elapsed,
        "sweeps_per_s": LJMIX_STEPS * st.n_chains / sim.sweep_seconds,
        "launches": launches, "launches_per_block": launches / blocks,
        "kernel_runs_per_round": sum(len(r) for r in runs), "kernel_run_lengths": runs,
        "acceptance": acceptance, "ledger_gap_per_particle": gap,
        "skip_frac": float(sim.mc.skipped.sum()) / (blocks * st.n_chains),
        "energy_per_particle": float(energy[-1, 1]), "profiled_block_sweeps": 1, "profiled_block": profile,
    })

    args = substep_inputs(st, sim.chains.table, spec, sim.inner, LJMIX_SIGMA)
    cb_cuda.disp_substep.launches = 0
    kv = compare(args, kinds_present(sim.chains.table))
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    emit({"phase": "kernel_vs_plain", "path": "cli_swap", "shapes": _shapes(args), "f32": kv})
    return launches, kv, _shapes(args)


# --- the pgmc-ka2d system (examples/pgmc-ka2d/run-study.py) ----------------
KA2D_COMPOSITION, KA2D_RHO, KA2D_T, KA2D_N, KA2D_CHAINS = (20, 11, 12), 1.1920748468939728, 0.5, 1290, 10
KA2D_BLOCKS = 4
# the learned theta of examples/pgmc-ka2d/README.md, held fixed
KA2D_THETA = {(0, 2): (0.49, -0.35), (1, 2): (0.11, 1.62)}


def ka2d_chains(device, seed=0, n=None, chains=None):
    """`chains` (KA2D_CHAINS) perturbed 2D lattices of `n` (KA2D_N)
    particles, species shuffled in the 20:11:12 composition, as
    run-study.py builds them."""
    from particlesmc_tpu_torch.core.state import make_system

    n, d = n or KA2D_N, 2
    rng = np.random.default_rng(seed)
    L = (n / KA2D_RHO) ** (1 / d)
    per = int(np.ceil(n ** (1 / d)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n]
    tot = sum(KA2D_COMPOSITION)
    na, nb = round(n * KA2D_COMPOSITION[0] / tot), round(n * KA2D_COMPOSITION[1] / tot)
    base = np.concatenate([np.full(na, 1), np.full(nb, 2), np.full(n - na - nb, 3)])
    pos, sp = [], []
    for _ in range(chains or KA2D_CHAINS):
        pos.append(grid + rng.uniform(-0.05 * a, 0.05 * a, (n, d)))
        s = base.copy()
        rng.shuffle(s)
        sp.append(s)
    return make_system(np.stack(pos), np.stack(sp), KA2D_RHO, KA2D_T, device=device)


def phase_library_energy_bias(device):
    """The pgmc-ka2d system through the library: Displacement (p 0.8) + two
    EnergyBias swaps (p 0.1 each) at the learned theta, float64."""
    from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    table = T.JBB(torch.float64, device)
    st = initialize_energy(ka2d_chains(device), table)
    counts0 = species_counts(st.species, 3)
    spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, KA2D_N)
    pool = (MB.displacement(0.05, 0.8),) + tuple(
        MB.discrete_swap(s1, s2, 0.1, policy="energy_bias", theta1=t1, theta2=t2)
        for (s1, s2), (t1, t2) in KA2D_THETA.items()
    )
    inner, sweeps = 8, 8
    params = MB.init_pool_params(pool, torch.float64, device)
    hs = CB.build_hyper_sweep_fn(spec, table, KA2D_N, inner=inner, sweeps=sweeps, pool=pool)
    cb = CB.init_cb_state(st, spec, seed=0, n_moves=len(pool))
    cb_cuda.disp_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(KA2D_BLOCKS):
        cb = hs(cb, params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cb_cuda.disp_substep.launches
    st = cb.system
    assert torch.equal(species_counts(st.species, 3), counts0), "a swap changed a chain's composition"
    e_dense = total_energy_dense(st.position, st.species, st.box, table)
    rel = float(((st.energy - e_dense).abs() / e_dense.abs()).max())
    assert rel <= 1e-9, f"ledger differs from the dense recompute by {rel} relative"
    accepted = cb.accepted.sum(dim=0).tolist()
    assert all(a >= 1 for a in accepted), f"a move was never accepted: {accepted}"
    expected, runs = expected_launches(pool, spec, inner, KA2D_N, sweeps * KA2D_BLOCKS)
    assert launches == expected > 0, f"{launches} kernel launches, expected {expected}"
    hs1 = CB.build_hyper_sweep_fn(spec, table, KA2D_N, inner=inner, sweeps=1, pool=pool)
    profile = profile_block(lambda: hs1(cb, params))
    emit({
        "phase": "library_energy_bias", "config": "pgmc-ka2d (2D JBB 20:11:12, rho 1.19207, T 0.5)",
        "N": KA2D_N, "chains": KA2D_CHAINS, "precision": "f64", "cells": list(spec.ncells),
        "cap": spec.cap, "inner": inner, "sweeps_per_rebin": sweeps, "blocks": KA2D_BLOCKS,
        "theta": {f"{s1 + 1}-{s2 + 1}": t for (s1, s2), t in KA2D_THETA.items()},
        "seconds": elapsed, "sweeps_per_s": sweeps * KA2D_BLOCKS * KA2D_CHAINS / elapsed,
        "launches": launches, "launches_per_block": launches / KA2D_BLOCKS,
        "kernel_runs_per_round": sum(len(r) for r in runs), "kernel_run_lengths": runs,
        "acceptance": move_acceptance(cb), "accepted": accepted, "ledger_max_rel_gap": rel,
        "skip_frac": float(cb.skipped.sum()) / (KA2D_BLOCKS * KA2D_CHAINS),
        "profiled_block_sweeps": 1, "profiled_block": profile,
    })
    return launches, (cb, spec, table, pool, params, inner, runs)


def phase_bias_kernel_vs_plain(cb, spec, table, pool, params, inner, runs, path="library_energy_bias"):
    """The kernel against its plain version at a pgmc-ka2d path's shapes
    (library_energy_bias or library_pgmc, `path`), on its final state
    (float64, B = 10; sigma from pool[0], the sweep's parameters from
    `params`): alone, at every run
    length that path's schedule launches (the plain version timed at the
    longest); then one whole sweep of the mixed pool, which cuts each
    colour into kernel runs on slices of the draws with the live centre
    lanes written back between slots, once through the kernel and once
    through its plain version from the same generator seed."""
    from particlesmc_tpu_torch.models.tables import kinds_present
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    kinds = kinds_present(table)
    sigma = dict(pool[0].params)["sigma"]
    lengths = sorted({n for row in runs for n in row})
    cb_cuda.disp_substep.launches = 0
    by_length = {}
    for n in lengths:
        args = substep_inputs(cb.system, table, spec, n, sigma)
        by_length[n] = compare(args, kinds, time_plain=n == lengths[-1])
    longest = by_length[lengths[-1]]

    hs1 = CB.build_hyper_sweep_fn(spec, table, cb.system.n_particles, inner=inner, sweeps=1, pool=pool)

    def sweep(substep):
        CB.disp_substep = substep
        try:
            return hs1(CB.init_cb_state(cb.system, spec, seed=11, n_moves=len(pool)), params)
        finally:
            CB.disp_substep = cb_cuda.disp_substep

    k_cb = sweep(cb_cuda.disp_substep)
    p_cb = sweep(lambda *a, kinds=None: cb_cuda.disp_substep_plain(*a))
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    ks, ps = k_cb.system, p_cb.system
    assert torch.equal(k_cb.attempted, p_cb.attempted) and torch.equal(k_cb.accepted, p_cb.accepted), \
        "the sweep's counters differ between the kernel and its plain version"
    assert torch.equal(ks.species, ps.species), "the sweep's species differ"
    pos_err = float((ks.position - ps.position).abs().max())
    e_rel = float(((ks.energy - ps.energy).abs() / ps.energy.abs()).max())
    assert pos_err <= 1e-9, f"the sweep's positions differ by {pos_err}"
    assert e_rel <= 1e-9, f"the sweep's ledgers differ by {e_rel} relative"
    sweep_out = {"position_max_abs_err": pos_err, "energy_max_rel_err": e_rel,
                 "accepted": k_cb.accepted.sum(dim=0).tolist()}
    shapes = _shapes(substep_inputs(cb.system, table, spec, lengths[-1], sigma))
    emit({"phase": "kernel_vs_plain", "path": path, "shapes": shapes,
          "run_lengths": lengths, "f64": {str(n): v for n, v in by_length.items()}, "sweep": sweep_out})
    errs = {"max_abs_err": max(v["max_abs_err"] for v in by_length.values()),
            "booked_max_rel_err": max(v["booked_max_rel_err"] for v in by_length.values())}
    return {**longest, **errs, "sweep": sweep_out}, shapes


def phase_cli_smart(device):
    """examples/movie/params.toml with SmartGaussian through the CLI: no
    Gaussian slot, so no kernel launch."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.moves import cb_cuda

    steps = 48
    with tempfile.TemporaryDirectory() as tmp:
        params = movie_params(
            tmp, steps,
            ('policy = "SimpleGaussian"', 'policy = "SmartGaussian"'),
            ("linear_interval = 500", "linear_interval = 16"),
            ("linear_interval = 1000", f"linear_interval = {steps}"),
        )
        cb_cuda.disp_substep.launches = 0
        sim = cli.run_file(params)
        torch.cuda.synchronize()
        launches = cb_cuda.disp_substep.launches
        accept = np.loadtxt(os.path.join(tmp, "moves", "1", "acceptance.dat"))
    st = sim.mc.system
    assert sim.pool[0].policy == "smart" and st.position.device.type == device.type
    acceptance = float(accept[-1, 1])
    assert 0.0 < acceptance < 1.0, f"acceptance {acceptance}"
    e_dense = float(total_energy_dense(st.position, st.species, st.box, sim.chains.table)[0])
    ledger = float(st.energy[0])
    assert math.isclose(ledger, e_dense, rel_tol=1e-9), (ledger, e_dense)
    assert launches == 0, f"{launches} kernel launches on a pool without a Gaussian slot"
    profile = profile_block(lambda: sim._block(1)(sim.mc, sim.pool_params))
    emit({
        "phase": "cli_smart", "params": f"examples/movie/params.toml (SmartGaussian, steps {steps})",
        "N": st.n_particles, "precision": "f64", "cells": list(sim.cb_spec.ncells), "cap": sim.cb_spec.cap,
        "inner": sim.inner, "sweep_seconds": sim.sweep_seconds, "sweeps_per_s": steps / sim.sweep_seconds,
        "launches": launches, "acceptance": acceptance, "ledger": ledger, "dense": e_dense,
        "profiled_block_sweeps": 1, "profiled_block": profile,
    })


# --- ortho-terphenyl production size (examples/ortho-terphenyl) -------------
MOL_CHAINS, MOL_INNER, MOL_REBIN, MOL_CAP, MOL_SIGMA, MOL_BLOCKS = 16, 16, 16, 32, 0.06, 2
MOL_GOLDEN = 25.65865662277199


def phase_library_molecular(device):
    """tests/fixtures/molecule.npz (1000 trimers, Trimer, T = 2.0, rho = 1.2)
    through the library: the golden energy, then 16 chains of Displacement
    (p 0.9) + MoleculeFlip (p 0.1) at the README's production settings."""
    from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
    from particlesmc_tpu_torch.core.state import bonds_from_pairs, make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "molecule.npz"))
    n = len(fx["species"])
    table = T.resolve_model(str(fx["model"]), 3, torch.float64, device)
    st = make_system(
        fx["position"], fx["species"], float(fx["density"]), float(fx["temperature"]),
        molecule=fx["molecule"], bonds=bonds_from_pairs(fx["bond_pairs"] - 1, n), box=fx["box"],
        device=device,
    )
    st = initialize_energy(st, table)
    golden = float(st.energy[0]) / n
    assert abs(golden - MOL_GOLDEN) <= 1e-6, f"energy per particle {golden}, golden {MOL_GOLDEN}"
    st = st.repeat(MOL_CHAINS)
    key0 = torch.sort(st.molecule * 3 + st.species, dim=-1).values  # each molecule's species multiset
    spec = CB.make_cb_spec(st.box[0].cpu().numpy(), T.interaction_range(table), n, MOL_CAP, occ_factor=4.0)
    assert spec.ncells == (8, 8, 8) and spec.n_active == 64, spec
    pool = (MB.displacement(MOL_SIGMA, 0.9), MB.molecule_flip(0.1))
    params = MB.init_pool_params(pool, torch.float64, device)
    max_bonds = int(st.bonds.shape[-1])
    hs = CB.build_hyper_sweep_fn(spec, table, n, inner=MOL_INNER, sweeps=MOL_REBIN, pool=pool,
                                 max_bonds=max_bonds)
    cb = CB.init_cb_state(st, spec, seed=0, n_moves=len(pool))
    cb_cuda.disp_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(MOL_BLOCKS):
        cb = hs(cb, params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cb_cuda.disp_substep.launches
    st = cb.system
    e_dense = total_energy_dense(st.position, st.species, st.box, table, st.bonds)
    rel = float(((st.energy - e_dense).abs() / e_dense.abs()).max())
    assert rel <= 1e-9, f"ledger differs from the dense recompute with bonds by {rel} relative"
    assert torch.equal(torch.sort(st.molecule * 3 + st.species, dim=-1).values, key0), \
        "a molecule's species multiset changed"
    acceptance = move_acceptance(cb)
    assert all(0.0 < a < 1.0 for a in acceptance), acceptance
    assert launches == 0, f"{launches} kernel launches on a molecular pool"
    # one sweep per rebin for the trace: a 16-sweep block is ~10^6 launches
    hs1 = CB.build_hyper_sweep_fn(spec, table, n, inner=MOL_INNER, sweeps=1, pool=pool, max_bonds=max_bonds)
    profile = profile_block(lambda: hs1(cb, params))
    emit({
        "phase": "library_molecular", "config": "molecule.npz (1000 trimers, Trimer, T 2.0, rho 1.2)",
        "N": n, "chains": MOL_CHAINS, "precision": "f64", "golden_energy_per_particle": golden,
        "cells": list(spec.ncells), "n_active": spec.n_active, "cap": spec.cap, "inner": MOL_INNER,
        "sweeps_per_rebin": MOL_REBIN, "blocks": MOL_BLOCKS, "seconds": elapsed,
        "sweeps_per_s": MOL_REBIN * MOL_BLOCKS * MOL_CHAINS / elapsed,
        "block_ms": 1e3 * elapsed / MOL_BLOCKS, "launches": launches, "acceptance": acceptance,
        "ledger_max_rel_gap": rel, "skip_frac": float(cb.skipped.sum()) / (MOL_BLOCKS * MOL_CHAINS),
        "profiled_block_sweeps": 1, "profiled_block": profile,
    })


# --- the sequential kernel at the reference benchmark matrix's sizes -------
# (benchmarks/scenarios.py, the reference's benchmark/particles_benchmarks.jl:
# 64 chains, sigma 0.1, float32 positions with a float64 ledger)
SEQ_CHAINS, SEQ_SIGMA, SEQ_TRACE_STEPS = 64, 0.1, 16
SEQ_SCENARIOS = {
    # name: (N, d, density, temperature, model, species fractions, cell list)
    "large-2d-dense": (1000, 2, 1.1920748468939728, 0.8, "JBB", (0.46, 0.26, 0.28), False),
    "larger-ss-3d-cell": (3000, 3, 0.5, 1.0, "BHHP", (0.5, 0.5), True),
}
SEQ_SWAP_CHAINS = 8
SEQ_MOL_CHAINS, SEQ_MOL_SIGMA = 4, 0.06


def scenario_config(n, d, density, fractions, seed=42):
    """benchmarks/scenarios.py's start: a perturbed lattice with the
    scenario's species fractions, shuffled."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1 / d)
    per_dim = int(np.ceil(n ** (1 / d)))
    a = L / per_dim
    grid = np.stack(np.meshgrid(*[np.arange(per_dim) * a + a / 2] * d, indexing="ij"), -1).reshape(-1, d)[:n]
    pos = grid + rng.uniform(-0.05 * a, 0.05 * a, (n, d))
    counts = [round(n * f) for f in fractions]
    counts[-1] = n - sum(counts[:-1])
    species = np.concatenate([np.full(c, s + 1) for s, c in enumerate(counts)])
    rng.shuffle(species)
    return pos, species


def sequential_sim(device, name, chains, pool, tmp, dtype=torch.float32):
    """A Simulation on the sequential kernel for one scenario (the engine's
    dense or force_cells cell-list choice), its chains `chains` copies of
    the scenario's start."""
    import warnings

    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io.loader import Chains
    from particlesmc_tpu_torch.models import tables as T

    n, d, rho, temp, model, fractions, cells = SEQ_SCENARIOS[name]
    table = getattr(T, model)(dtype, device)
    pos, species = scenario_config(n, d, rho, fractions)
    st = make_system(pos, species, rho, temp, dtype=dtype, device=device)
    wide = torch.float64 if dtype == torch.float32 else None
    st = initialize_energy(st, table, energy_dtype=wide).repeat(chains)
    bundle = Chains(states=st, table=table, list_type="cell" if cells else "dense",
                    list_parameters={"force_cells": True} if cells else {}, n_chains=chains)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the cell path's warning is the point here
        sim = Simulation(bundle, [dict(algorithm="Metropolis", pool=pool, seed=42)], 1, path=tmp)
    assert sim.neighbour_mode == ("cell" if cells else "dense"), sim.neighbour_mode
    return sim


def trace_steps(sim, mc):
    """Device launches and stream synchronisations per step, from a traced
    sweep of SEQ_TRACE_STEPS steps (one untraced call first builds its
    device constants)."""
    import dataclasses

    from particlesmc_tpu_torch.moves import kernel as K

    sweep = K.build_sweep_fn(dataclasses.replace(sim.config, sweepstep=SEQ_TRACE_STEPS), sim.chains.n_particles)
    sweep(mc, sim.pool_params)
    prof = profile_block(lambda: sweep(mc, sim.pool_params))
    prof["launches_per_step"] = prof["device_launches"] / SEQ_TRACE_STEPS
    prof["syncs_per_step"] = prof["stream_syncs"] / SEQ_TRACE_STEPS
    return prof


def ledger_gap(mc, table, per_particle=True):
    """Largest |ledger - dense float64 recompute| over the chains, per
    particle (or relative)."""
    from particlesmc_tpu_torch.core.energy import total_energy_dense

    st = mc.system
    e = total_energy_dense(st.position.double(), st.species, st.box.double(), table.astype(torch.float64), st.bonds)
    gap = (st.energy.double() - e).abs()
    return float(gap.max()) / st.n_particles if per_particle else float((gap / e.abs()).max())


def seq_timed(sim, warmup_steps=None):
    """Seconds of one sweep, after one warm-up sweep (of `warmup_steps`
    steps; a whole sweep by default); the state after."""
    import dataclasses

    from particlesmc_tpu_torch.moves import kernel as K

    n = sim.chains.n_particles
    sweep = K.build_sweep_fn(sim.config, n)
    warm = sweep if warmup_steps is None else K.build_sweep_fn(dataclasses.replace(sim.config, sweepstep=warmup_steps), n)
    mc = warm(sim.mc, sim.pool_params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = sweep(mc, sim.pool_params)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, mc


def seq_cpu_vs_card(device):
    """One float64 sweep at N = 64 (large-2d-dense's state point) on the
    card and on the CPU, on the same injected draws: same counters, species
    and positions within 1e-9."""
    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import kernel as K

    n, d, rho, temp, model, fractions, _ = SEQ_SCENARIOS["large-2d-dense"]
    n, chains = 64, 4
    pos, species = scenario_config(n, d, rho, fractions)
    g = np.random.default_rng(3)
    draws = dict(
        move=np.zeros((chains, n), np.int64), i=g.integers(0, n, (chains, n)),
        normal=g.normal(0, 1, (chains, n, d)), u=g.uniform(1e-300, 1, (chains, n)),
    )
    pool = (MB.displacement(SEQ_SIGMA),)
    out = []
    for dev in (torch.device("cpu"), device):
        table = getattr(T, model)(torch.float64, dev)
        st = initialize_energy(make_system(pos, species, rho, temp, device=dev), table).repeat(chains)
        config = K.KernelConfig(pool=pool, table=table, cell_spec=None)
        mc = K.init_mc_state(st, config, 0)
        out.append(K.build_sweep_fn(config, n)(
            mc, MB.init_pool_params(pool, torch.float64, dev), {k: torch.tensor(v, device=dev) for k, v in draws.items()}
        ))
    a, b = out
    assert torch.equal(a.attempted, b.attempted.cpu()) and torch.equal(a.accepted, b.accepted.cpu()), \
        "the card's counters differ from the CPU's"
    assert torch.equal(a.system.species, b.system.species.cpu())
    err = float((a.system.position - b.system.position.cpu()).abs().max())
    assert err <= 1e-9, f"the card's positions differ from the CPU's by {err}"
    assert int(a.accepted.sum()) > 0
    return {"N": n, "chains": chains, "position_max_abs_err": err, "accepted": int(a.accepted.sum())}


def phase_library_sequential(device):
    """The sequential kernel through the library at two scenarios of the
    reference benchmark matrix: large-2d-dense (dense ΔE) and
    larger-ss-3d-cell (cell list through force_cells); then the card against
    the CPU on the same draws."""
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import kernel as K

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SEQ_SCENARIOS:
            n = SEQ_SCENARIOS[name][0]
            sim = sequential_sim(device, name, SEQ_CHAINS, (MB.displacement(SEQ_SIGMA),), tmp)
            cb_cuda.disp_substep.launches = 0
            elapsed, mc = seq_timed(sim)
            assert cb_cuda.disp_substep.launches == 0
            K.check_state(mc)  # no cell overflow
            acceptance = move_acceptance(mc)[0]
            assert 0.0 < acceptance < 1.0, f"{name}: acceptance {acceptance}"
            gap = ledger_gap(mc, sim.chains.table)
            assert gap <= 1e-5, f"{name}: ledger differs from the dense recompute by {gap} per particle"
            spec = sim.config.cell_spec
            out[name] = {
                "N": n, "d": SEQ_SCENARIOS[name][1], "model": SEQ_SCENARIOS[name][4], "chains": SEQ_CHAINS,
                "mode": sim.neighbour_mode, "cells": None if spec is None else list(spec.ncells),
                "cap": None if spec is None else spec.cap, "precision": "mixed", "sigma": SEQ_SIGMA,
                "ms_per_sweep": 1e3 * elapsed, "us_per_step": 1e6 * elapsed / n,
                "us_per_step_per_chain": 1e6 * elapsed / (n * SEQ_CHAINS), "sweeps_per_s": SEQ_CHAINS / elapsed,
                "acceptance": acceptance, "ledger_gap_per_particle": gap,
                "traced_steps": SEQ_TRACE_STEPS, "profiled": trace_steps(sim, mc),
            }
    out["cpu_vs_card"] = seq_cpu_vs_card(device)
    emit({"phase": "library_sequential", **out})
    return out


def phase_library_sequential_swap(device):
    """large-2d-dense with 8 chains, one sweep of Displacement (0.8) +
    DiscreteSwap 1<->3 DoubleUniform (0.1) + DiscreteSwap 2<->3 EnergyBias
    at examples/pgmc-ka2d's learned theta (0.1)."""
    from particlesmc_tpu_torch.moves import base as MB

    (t1, t2) = KA2D_THETA[(1, 2)]
    pool = (
        MB.displacement(SEQ_SIGMA, 0.8),
        MB.discrete_swap(0, 2, 0.1),
        MB.discrete_swap(1, 2, 0.1, policy="energy_bias", theta1=t1, theta2=t2),
    )
    with tempfile.TemporaryDirectory() as tmp:
        sim = sequential_sim(device, "large-2d-dense", SEQ_SWAP_CHAINS, pool, tmp)
    counts0 = species_counts(sim.mc.system.species, 3)
    elapsed, mc = seq_timed(sim, SEQ_TRACE_STEPS)
    assert torch.equal(species_counts(mc.system.species, 3), counts0), "a swap changed a chain's composition"
    gap = ledger_gap(mc, sim.chains.table)
    assert gap <= 1e-5, f"ledger differs from the dense recompute by {gap} per particle"
    accepted = mc.accepted.sum(dim=0).tolist()
    assert all(a >= 1 for a in accepted[:2]), f"a move was never accepted: {accepted}"
    n = sim.chains.n_particles
    emit({
        "phase": "library_sequential_swap", "config": "large-2d-dense (2D JBB, rho 1.19207, T 0.8)", "N": n,
        "chains": SEQ_SWAP_CHAINS, "precision": "mixed", "theta_2_3": [t1, t2],
        "ms_per_sweep": 1e3 * elapsed, "us_per_step": 1e6 * elapsed / n, "sweeps_per_s": SEQ_SWAP_CHAINS / elapsed,
        "warmup_steps": SEQ_TRACE_STEPS,
        "acceptance": move_acceptance(mc), "accepted": accepted, "ledger_gap_per_particle": gap,
        "traced_steps": SEQ_TRACE_STEPS, "profiled": trace_steps(sim, mc),
    })


def molecular_sim(device, chains, tmp):
    """molecule.npz x `chains` on the sequential kernel, float64,
    Displacement (0.9) + MoleculeFlip (0.1); and the start's energy per
    particle."""
    import warnings

    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import bonds_from_pairs, make_system, mol_table
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io.loader import Chains
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "molecule.npz"))
    n = len(fx["species"])
    table = T.resolve_model(str(fx["model"]), 3, torch.float64, device)
    st = make_system(
        fx["position"], fx["species"], float(fx["density"]), float(fx["temperature"]),
        molecule=fx["molecule"], bonds=bonds_from_pairs(fx["bond_pairs"] - 1, n), box=fx["box"], device=device,
    )
    st = initialize_energy(st, table)
    golden = float(st.energy[0]) / n
    st = st.repeat(chains)
    ms, ml = mol_table(st.molecule[0].cpu().numpy())
    pool = (MB.displacement(SEQ_MOL_SIGMA, 0.9), MB.molecule_flip(0.1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = Simulation(Chains(states=st, table=table, list_type="dense", n_chains=chains,
                                mol_start=ms, mol_len=ml),
                         [dict(algorithm="Metropolis", pool=pool, seed=42)], 1, path=tmp)
    return sim, golden


def phase_library_sequential_molecular(device):
    """molecule.npz x 4 chains through the sequential kernel, float64,
    Displacement (0.9) + MoleculeFlip (0.1), one sweep."""
    with tempfile.TemporaryDirectory() as tmp:
        sim, golden = molecular_sim(device, SEQ_MOL_CHAINS, tmp)
    assert abs(golden - MOL_GOLDEN) <= 1e-6, f"energy per particle {golden}, golden {MOL_GOLDEN}"
    table = sim.chains.table
    st = sim.mc.system
    n = st.n_particles
    key0 = torch.sort(st.molecule * 3 + st.species, dim=-1).values  # each molecule's species multiset
    elapsed, mc = seq_timed(sim, SEQ_TRACE_STEPS)
    from particlesmc_tpu_torch.moves import kernel as K

    K.check_state(mc)
    rel = ledger_gap(mc, table, per_particle=False)
    assert rel <= 1e-9, f"ledger differs from the dense recompute with bonds by {rel} relative"
    assert torch.equal(torch.sort(mc.system.molecule * 3 + mc.system.species, dim=-1).values, key0), \
        "a molecule's species multiset changed"
    acceptance = move_acceptance(mc)
    assert all(0.0 < a < 1.0 for a in acceptance), acceptance
    emit({
        "phase": "library_sequential_molecular", "config": "molecule.npz (1000 trimers, Trimer, T 2.0, rho 1.2)",
        "N": n, "chains": SEQ_MOL_CHAINS, "precision": "f64", "golden_energy_per_particle": golden,
        "flip_rounds": mc.flip_rounds, "warmup_steps": SEQ_TRACE_STEPS, "ms_per_sweep": 1e3 * elapsed,
        "us_per_step": 1e6 * elapsed / n,
        "sweeps_per_s": SEQ_MOL_CHAINS / elapsed, "acceptance": acceptance, "ledger_max_rel_gap": rel,
        "traced_steps": SEQ_TRACE_STEPS, "profiled": trace_steps(sim, mc),
    })


TEMPER_LADDER = [1.0, 1.1, 1.2, 1.3]


def phase_cli_tempering(device):
    """examples/movie through the CLI on a temperature ladder, twice: the
    sequential kernel (4 steps, ReplicaExchange and AdaptiveSigma every
    step), then the checkerboard (32 steps, ReplicaExchange every 8), and
    the kernel against its plain version at the tempered run's shapes.
    Returns the checkerboard run's kernel launches, that comparison and
    its shapes."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.moves import cb_cuda

    out = {}
    for backend, steps, rex_every in (("sequential", 4, 1), ("checkerboard", 32, 8)):
        extra = (
            f'\n[[simulation.output]]\nalgorithm = "ReplicaExchange"\n'
            f"scheduler_params = {{linear_interval = {rex_every}}}\n"
        )
        if backend == "sequential":
            extra += '\n[[simulation.output]]\nalgorithm = "AdaptiveSigma"\nscheduler_params = {linear_interval = 1}\n'
        with tempfile.TemporaryDirectory() as tmp:
            params = movie_params(
                tmp, steps,
                ("temperature = 1.0", f"temperature = {TEMPER_LADDER}"),
                ("parallel_moves = true", f"parallel_moves = {str(backend == 'checkerboard').lower()}"),
                ("linear_interval = 500", f"linear_interval = {rex_every}"),
                ("linear_interval = 1000", f"linear_interval = {steps}"),
            )
            with open(params, "a") as f:
                f.write(extra)
            cb_cuda.disp_substep.launches = 0
            t0 = time.perf_counter()
            sim = cli.run_file(params)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = cb_cuda.disp_substep.launches
            rex = np.loadtxt(os.path.join(tmp, "tempering_acceptance.dat"), ndmin=2)
            sigma = None
            if backend == "sequential":
                sigma = np.loadtxt(os.path.join(tmp, "moves", "1", "sigma.dat"), ndmin=2)
                assert sigma.shape[0] == steps - 1, sigma  # the first event takes the counters
        st = sim.mc.system
        assert st.position.device.type == device.type and st.n_chains == len(TEMPER_LADDER)
        assert rex.shape == (steps // rex_every, 2), rex.shape
        assert st.temperature.cpu().tolist() == TEMPER_LADDER, "a temperature left its slot"
        e = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
        rel = float(((st.energy - e).abs() / e.abs()).max())
        assert rel <= 1e-9, f"{backend}: a chain's ledger differs from the dense recompute by {rel} relative"
        if backend == "checkerboard":
            expected, _ = expected_launches(sim.pool, sim.cb_spec, sim.inner, sim.sweepstep, steps)
            assert launches == expected > 0, f"{launches} kernel launches, expected {expected}"
        else:
            assert launches == 0
        out[backend] = {
            "steps": steps, "replica_exchange_every": rex_every, "run_file_seconds": elapsed,
            "sweep_seconds": sim.sweep_seconds, "sweeps_per_s": steps * st.n_chains / sim.sweep_seconds,
            "launches": launches, "tempering_acceptance": float(rex[-1, 1]),
            "rex_accepted": sim._rex.accepted, "rex_attempted": sim._rex.attempted,
            "acceptance": move_acceptance(sim.mc), "ledger_max_rel_gap": rel,
            "sigma": None if sigma is None else sigma[:, 1].tolist(),
        }
    emit({"phase": "cli_tempering", "params": "examples/movie/params.toml", "N": st.n_particles,
          "precision": "f64", "ladder": TEMPER_LADDER, **out})
    return (out["checkerboard"]["launches"],) + phase_cli_kernel_vs_plain(sim, "cli_tempering")


# --- PGMC (examples/pgmc-ka2d/run-study.py, and the reference's own
# test/pgmc_ka2d.jl scenario) -----------------------------------------------
PGMC_STEPS, PGMC_EVERY, PGMC_Q, PGMC_TIMED = 40, 10, 10, 5
PGMC_SEQ_N, PGMC_SEQ_CHAINS, PGMC_SEQ_STEPS = 43, 10, 20
CKPT_STEPS, CKPT_SEQ_CHAINS, CKPT_SEQ_STEPS = 64, 8, 4


def pgmc_pool(MB):
    """run-study.py's pool from theta = 0: Displacement sigma 0.05 (p 0.8),
    EnergyBias swaps 1<->3 and 2<->3 (p 0.1 each)."""
    return (
        MB.displacement(0.05, probability=0.8),
        MB.discrete_swap(0, 2, 0.1, policy="energy_bias"),
        MB.discrete_swap(1, 2, 0.1, policy="energy_bias"),
    )


def pgmc_sim(device, tmp, sequential):
    """The PGMC run as a Simulation on `device`: the pgmc-ka2d system on the
    checkerboard backend (run-study.py's optimisers VPG(1e-3), VPG(3e-2) x 2,
    q_batch_size 10, an estimate every 10 sweeps, an update and a
    StoreParameters row every 10), or the N = 43 scenario on the sequential
    dense kernel (VPG(1e-3), BLANPG(1e-4, 1e-6) x 2, an estimate every
    sweep, an update every 2); and its StoreParameters schedule."""
    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.engine.pgmc import BLANPG, VPG
    from particlesmc_tpu_torch.engine.schedule import build_schedule
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io.loader import Chains
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB

    table = T.JBB(torch.float64, device)
    small = dict(n=PGMC_SEQ_N, chains=PGMC_SEQ_CHAINS) if sequential else {}
    st = initialize_energy(ka2d_chains(device, **small), table)
    if sequential:
        steps, every, upd = PGMC_SEQ_STEPS, 1, 2
        optimisers = (VPG(1e-3), BLANPG(1e-4, 1e-6), BLANPG(1e-4, 1e-6))
    else:
        steps, every, upd = PGMC_STEPS, PGMC_EVERY, PGMC_EVERY
        optimisers = (VPG(1e-3), VPG(3e-2), VPG(3e-2))
    sched = build_schedule(steps, 0, upd)
    algorithms = [
        dict(algorithm="Metropolis", pool=pgmc_pool(MB), seed=42, parallel_moves=not sequential),
        dict(algorithm="PolicyGradientEstimator", optimisers=optimisers, q_batch_size=PGMC_Q, q_every=every),
        dict(algorithm="PolicyGradientUpdate", scheduler=sched),
        dict(algorithm="StoreParameters", scheduler=sched),
    ]
    chains = Chains(states=st, table=table, list_type="dense" if sequential else "cell", n_chains=st.n_chains)
    return Simulation(chains, algorithms, steps, path=tmp, verbose=False), sched


def estimate_cpu_vs_card(sim, tmp, sequential):
    """One estimate() on the card and one on the CPU twin of the run (its
    final state and theta), on the same fed-in actions drawn on the card:
    each learnable move's accumulated g and F, elementwise within 1e-9
    relative (1e-12 of the largest entry absolute)."""
    pg = sim._pgmc
    st = sim.mc.system
    props = [
        pg.sample_prop(sim.pool_params[m], m, pg.generator, st, None, pg.q_batch_size) if learn else None
        for m, learn in enumerate(pg.learnable)
    ]
    twin, _ = pgmc_sim(torch.device("cpu"), tmp, sequential)
    twin.mc = twin.mc.replace(system=st.replace(**{
        f: getattr(st, f).cpu() for f in ("position", "species", "box", "temperature", "density", "energy")
    }))
    twin.pool_params = tuple({k: v.cpu() for k, v in p.items()} for p in sim.pool_params)
    out = {}
    for g, props_g in ((pg, props), (twin._pgmc, [None if p is None else type(p)(*(t.cpu() for t in p))
                                                  for p in props])):
        g._acc = [None] * len(g._acc)
        g.estimate(props_g)
    errs = {}
    for m, learn in enumerate(pg.learnable):
        if not learn:
            continue
        for k, name in ((0, "g"), (1, "F")):
            a, b = pg._acc[m][k].cpu(), twin._pgmc._acc[m][k]
            scale = float(b.abs().max())
            err = (a - b).abs() / torch.clamp_min(b.abs(), 1e-12 * scale)
            errs[f"{m}.{name}"] = float(err.max())
            assert scale > 0 and errs[f"{m}.{name}"] <= 1e-9, f"move {m} {name}: card and CPU differ by {err.max()}"
        out[m] = {"g": pg._acc[m][0].tolist()}
    pg._acc = [None] * len(pg._acc)  # the comparison's estimates are not kept
    return {"max_rel_err": errs, "card_g": out}


def estimator_cost(sim):
    """Milliseconds of one estimate() on the card (CUDA events, median of
    PGMC_TIMED), and the device launches and stream synchronisations of one
    traced call."""
    pg = sim._pgmc
    ms = _time_ms(pg.estimate, runs=PGMC_TIMED)
    prof = profile_block(pg.estimate)
    pg._acc = [None] * len(pg._acc)  # the timed estimates are not kept
    return {"estimate_ms": ms, "estimate_device_launches": prof["device_launches"],
            "estimate_stream_syncs": prof["stream_syncs"], "estimate_device_busy_ms": prof["device_busy_ms"],
            "estimate_idle_share": prof["idle_share"], "estimate_top": prof["top_glue"]}


def run_pgmc(device, sequential):
    """Drive one PGMC path and check it: kernel launches, moved and finite
    sigma and theta, one parameters.dat row per StoreParameters event,
    compositions, the ledger against the dense recompute, the card's
    estimate against the CPU's."""
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.moves import cb_cuda

    with tempfile.TemporaryDirectory() as tmp:
        sim, sched = pgmc_sim(device, tmp, sequential)
        st0 = sim.mc.system
        counts0 = species_counts(st0.species, 3)
        theta0 = [{k: float(v) for k, v in p.items()} for p in sim.pool_params]
        cb_cuda.disp_substep.launches = 0
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = cb_cuda.disp_substep.launches
        rows = [np.loadtxt(os.path.join(tmp, "moves", str(m + 1), "parameters.dat"), ndmin=2) for m in range(3)]
        vs_cpu = estimate_cpu_vs_card(sim, os.path.join(tmp, "cpu"), sequential)
    theta = [{k: float(v) for k, v in p.items()} for p in sim.pool_params]
    flat0 = [v for p in theta0 for v in p.values()]
    flat = [v for p in theta for v in p.values()]
    assert all(math.isfinite(v) for v in flat), theta
    assert all(a != b for a, b in zip(flat, flat0)), f"a parameter did not move: {theta0} -> {theta}"
    assert theta[0]["sigma"] > 0
    for r, p in zip(rows, theta):
        assert r.shape == (len(sched), 1 + len(p)), r.shape
        np.testing.assert_array_equal(r[:, 0], sched)
    st = sim.mc.system
    assert torch.equal(species_counts(st.species, 3), counts0), "a swap changed a chain's composition"
    e = total_energy_dense(st.position, st.species, st.box, sim.chains.table)
    rel = float(((st.energy - e).abs() / e.abs()).max())
    assert rel <= 1e-9, f"ledger differs from the dense recompute by {rel} relative"
    n, chains, steps = st.n_particles, st.n_chains, int(sim.steps)
    if sequential:
        expected, runs = 0, None
    else:
        expected, runs = expected_launches(sim.pool, sim.cb_spec, sim.inner, sim.sweepstep, steps)
    assert launches == expected, f"{launches} kernel launches, expected {expected}"
    out = {
        "N": n, "chains": chains, "precision": "f64", "steps": steps, "backend": sim.neighbour_mode,
        "q_batch_size": sim._pgmc.q_batch_size, "q_every": sim._pgmc_every,
        "optimisers": [repr(o) for o in sim._pgmc.optimisers],
        "run_seconds": elapsed, "sweep_seconds": sim.sweep_seconds,
        "sweeps_per_s": steps * chains / elapsed, "sweeps_per_s_sweeps_alone": steps * chains / sim.sweep_seconds,
        "launches": launches, "theta_start": theta0, "theta_end": theta, "parameter_rows": len(sched),
        "acceptance": move_acceptance(sim.mc), "ledger_max_rel_gap": rel, "estimate_card_vs_cpu": vs_cpu,
        **estimator_cost(sim),
    }
    if not sequential:
        out.update(cells=list(sim.cb_spec.ncells), cap=sim.cb_spec.cap, inner=sim.inner,
                   sweeps_per_rebin=sim.rebin_every, kernel_run_lengths=runs)
    return sim, launches, runs, out


def phase_library_pgmc(device):
    """examples/pgmc-ka2d/run-study.py's configuration through Simulation on
    the checkerboard backend (2D JBB, N = 1290, 20:11:12, 10 chains, f64),
    PGMC_STEPS sweeps; then the kernel against its plain version at this
    path's shapes with the learned sigma and theta."""
    from particlesmc_tpu_torch.moves import base as MB

    sim, launches, runs, out = run_pgmc(device, sequential=False)
    emit({"phase": "library_pgmc", "config": "pgmc-ka2d run-study.py (2D JBB 20:11:12, rho 1.19207, T 0.5)",
          "cut": f"{PGMC_STEPS} sweeps of run-study's 2000", **out})
    sigma = float(sim.pool_params[0]["sigma"])
    pool = (MB.displacement(sigma, 0.8),) + sim.pool[1:]
    kp, shapes = phase_bias_kernel_vs_plain(sim.mc, sim.cb_spec, sim.chains.table, pool, sim.pool_params,
                                            sim.inner, runs, path="library_pgmc")
    return launches, kp, shapes


def phase_library_pgmc_sequential(device):
    """The reference's own PGMC scenario (test/pgmc_ka2d.jl, as
    tests/test_pgmc.py runs it): N = 43, 10 chains, the sequential dense
    kernel, PGMC_SEQ_STEPS sweeps (no kernel launch)."""
    _, _, _, out = run_pgmc(device, sequential=True)
    emit({"phase": "library_pgmc_sequential", "config": "test/pgmc_ka2d.jl (2D JBB N = 43, 20:11:12)", **out})


def states_equal(a, b):
    """The fields of two sampler states that differ, by name: positions,
    species, energies and counters (bitwise)."""
    out = [f for f in ("position", "species", "energy") if not torch.equal(getattr(a.system, f), getattr(b.system, f))]
    return out + [f for f in ("attempted", "accepted") if not torch.equal(getattr(a, f), getattr(b, f))]


def phase_checkpoint(device):
    """Exact resume on the card: examples/movie through the CLI on the
    checkerboard (the kernel path), 64 steps with StoreCheckpoints at 32,
    then --resume from it; and large-2d-dense on the sequential dense kernel
    (8 chains, 4 sweeps, a checkpoint at 2) through the library. Each
    resumed run's final positions, species, energies and counters must equal
    the straight-through run's bitwise."""
    import warnings

    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda

    out = {}
    steps = CKPT_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        params = movie_params(
            tmp, steps,
            ("linear_interval = 500", "linear_interval = 16"),
            ("linear_interval = 1000", f"linear_interval = {steps}"),
        )
        with open(params, "a") as f:
            f.write('\n[[simulation.output]]\nalgorithm = "StoreCheckpoints"\n'
                    f"scheduler_params = {{linear_interval = {steps // 2}}}\nhistory = true\n")
        cb_cuda.disp_substep.launches = 0
        a = cli.run_file(params)
        launches_a = cb_cuda.disp_substep.launches
        ckpt = os.path.join(tmp, f"checkpoint_{steps // 2}.npz")
        energy_a = np.loadtxt(os.path.join(tmp, "chains", "1", "energy.dat"))
        cb_cuda.disp_substep.launches = 0
        t0 = time.perf_counter()
        b = cli.run_file(params, resume=ckpt)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches_b = cb_cuda.disp_substep.launches
        energy_b = np.loadtxt(os.path.join(tmp, "chains", "1", "energy.dat"))
        size = os.path.getsize(ckpt)
    differ = states_equal(a.mc, b.mc)
    assert not differ, f"checkerboard resume: {differ} differ from the straight-through run"
    assert a.mc.system.position.device.type == device.type and launches_b * 2 == launches_a > 0
    tail = energy_a[energy_a[:, 0] > steps // 2]  # the rows the resumed run appends
    assert energy_b.shape[0] == energy_a.shape[0] + len(tail) > energy_a.shape[0], "energy.dat was not appended to"
    np.testing.assert_array_equal(energy_b[-len(tail):], tail)
    out["checkerboard_cli"] = {"params": "examples/movie/params.toml", "steps": steps, "checkpoint_at": steps // 2,
                               "bitwise": True, "launches": [launches_a, launches_b], "resume_seconds": resume_s,
                               "checkpoint_bytes": size}

    pool = (MB.displacement(SEQ_SIGMA),)
    with tempfile.TemporaryDirectory() as tmp:
        base = sequential_sim(device, "large-2d-dense", CKPT_SEQ_CHAINS, pool, tmp)
        half = CKPT_SEQ_STEPS // 2
        algos = [dict(algorithm="Metropolis", pool=pool, seed=42), dict(algorithm="StoreCheckpoints", scheduler=[half])]
        runs = []
        for resume in (None, os.path.join(tmp, "checkpoint.npz")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sim = Simulation(base.chains, algos, CKPT_SEQ_STEPS, path=tmp, verbose=False, resume=resume)
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            runs.append((sim, time.perf_counter() - t0))
    (a, ta), (b, tb) = runs
    differ = states_equal(a.mc, b.mc)
    assert not differ, f"sequential resume: {differ} differ from the straight-through run"
    assert a.mc.system.position.device.type == device.type and b._start_step == half
    assert int(a.mc.accepted.sum()) > 0
    out["sequential_dense"] = {"scenario": "large-2d-dense", "chains": CKPT_SEQ_CHAINS, "precision": "mixed",
                               "steps": CKPT_SEQ_STEPS, "checkpoint_at": half, "bitwise": True, "seconds": [ta, tb]}
    emit({"phase": "checkpoint", **out})


# --- the observables (analysis/, core/energy.py::pressure, profile_dir) ----
ANA_CHAINS, ANA_CPU_PRESSURE_CHAINS, ANA_CPU_GR_CHAINS, ANA_STEPS = 8, 1, 2, 32


def phase_analysis(device, cb):
    """The observables on the card: the virial pressure of 8 of the library
    path's final chains (KA-LJ N = 10,000, 3D; float32 positions taken to
    float64) against a float64 CPU computation of chain 0 (rtol 1e-9), g(r)
    of the 8 chains with the first 2 against the CPU (the same histogram
    counts), then a 32-step examples/movie run through the CLI with
    `profile_dir` (a non-empty trace file) whose 16 stored frames give the
    MSD and F_s(k, t) on the card against the CPU (within 1e-12)."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.analysis import structure as A
    from particlesmc_tpu_torch.core.energy import pressure
    from particlesmc_tpu_torch.io import formats
    from particlesmc_tpu_torch.models import tables as T

    cpu = torch.device("cpu")
    st = cb.system
    k = ANA_CHAINS
    pos, sp, box = st.position[:k].double(), st.species[:k], st.box[:k].double()
    rho, temp = st.density[:k].double(), st.temperature[:k].double()
    seconds = {}

    def timed_s(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    table = T.KobAndersen(torch.float64, device)
    p_card = timed_s("pressure_card", lambda: pressure(pos, sp, box, table, rho, temp))
    # a second, warm call: the first one includes the first-use costs
    timed_s("pressure_card_warm", lambda: pressure(pos, sp, box, table, rho, temp))
    c = ANA_CPU_PRESSURE_CHAINS
    p_cpu = timed_s("pressure_cpu", lambda: pressure(
        pos[:c].cpu(), sp[:c].cpu(), box[:c].cpu(), T.KobAndersen(torch.float64, cpu), rho[:c].cpu(), temp[:c].cpu()))
    p_rel = float(((p_card[:c].cpu() - p_cpu).abs() / p_cpu.abs()).max())
    assert bool(torch.isfinite(p_card).all()) and p_rel <= 1e-9, f"pressure: card and CPU differ by {p_rel} relative"
    nb, rmax = 200, 5.0
    _, g_card = timed_s("gr_card", lambda: A.radial_distribution(pos, box[0], nbins=nb, rmax=rmax))
    timed_s("gr_card_warm", lambda: A.radial_distribution(pos, box[0], nbins=nb, rmax=rmax))
    c = ANA_CPU_GR_CHAINS
    _, g_c2 = A.radial_distribution(pos[:c], box[0], nbins=nb, rmax=rmax)
    _, g_cpu = timed_s("gr_cpu", lambda: A.radial_distribution(pos[:c].cpu(), box[0].cpu(), nbins=nb, rmax=rmax))
    assert np.array_equal(g_c2, g_cpu), "g(r): the card's histogram differs from the CPU's"
    peak = int(np.argmax(g_card))
    assert np.isfinite(g_card).all() and 1.5 < g_card[peak] < 6.0, g_card[peak]

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace")
        params = movie_params(
            tmp, ANA_STEPS,
            ("seed = 10", f'seed = 10\nprofile_dir = "{trace}"'),
            ("linear_interval = 500}\nfmt", "linear_interval = 2}\nfmt"),
        )
        t0 = time.perf_counter()
        cli.run_file(params)
        torch.cuda.synchronize()
        seconds["movie_with_profile"] = time.perf_counter() - t0
        traces = [os.path.join(trace, f) for f in os.listdir(trace) if f.endswith(".json")]
        trace_bytes = max(os.path.getsize(f) for f in traces) if traces else 0
        frames = formats.read_trajectory(os.path.join(tmp, "chains", "1", "trajectory.exyz"))
    assert trace_bytes > 0, "profile_dir left no trace"
    frames = frames[:16]
    assert len(frames) == 16
    traj = np.stack([f["position"] for f in frames])
    tbox = np.asarray(frames[0]["box"], np.float64)
    # numpy frames, as formats.read_trajectory gives them, on the card and on the CPU
    msd_card = timed_s("msd_card", lambda: A.mean_squared_displacement(traj, tbox, device=device))
    msd_cpu = A.mean_squared_displacement(traj, tbox, device=cpu)
    unwrapped = A.unwrap_trajectory(traj, tbox, device=cpu)
    fs_card = timed_s("fskt_card", lambda: A.self_intermediate_scattering(unwrapped, tbox, 7.4, device=device))
    fs_cpu = A.self_intermediate_scattering(unwrapped, tbox, 7.4, device=cpu)
    msd_err = float(np.abs(msd_card - msd_cpu).max())
    fs_err = float(np.abs(fs_card - fs_cpu).max())
    assert msd_err <= 1e-12 and fs_err <= 1e-12, (msd_err, fs_err)
    assert msd_cpu[-1] > 0 and fs_cpu[0] == 1.0 and fs_cpu[-1] < 1.0
    emit({
        "phase": "analysis", "chains": k, "N": st.n_particles, "pressure": p_card.tolist(),
        "pressure_max_rel_err": p_rel, "pressure_cpu_chains": ANA_CPU_PRESSURE_CHAINS,
        "gr_peak_r": (peak + 0.5) * rmax / nb, "gr_peak": float(g_card[peak]),
        "gr_cpu_chains": ANA_CPU_GR_CHAINS, "gr_counts_equal": True,
        "movie_steps": ANA_STEPS, "frames": len(frames), "trace_bytes": trace_bytes,
        "msd_last": float(msd_cpu[-1]), "fskt_last": float(fs_cpu[-1]),
        "msd_max_abs_err": msd_err, "fskt_max_abs_err": fs_err, "seconds": seconds,
    })


# --- the main path with the candidate compaction (list_parameters trim = "auto")
TRIM_TIMED_BLOCKS = 3
# device launches of the untrimmed main path's traced block: a fixed count
# (the block issues the same launches whatever the draws), which the
# candidate compaction's code must leave as it was
MAIN_DEVICE_LAUNCHES = 8320


def phase_library_trim(device, kv, untrimmed_profile):
    """The main path's configuration with trim = "auto" (auto_trim_k: 512
    neighbour lanes, LP 544), after a check that the untrimmed library
    block's traced device launches (`untrimmed_profile`) are still
    MAIN_DEVICE_LAUNCHES: a warm-up and TRIM_TIMED_BLOCKS timed blocks, a
    traced block, the ledger against a dense recompute; then the kernel
    against its plain version at the trimmed shapes (f64 and f32), its ms
    per launch beside the untrimmed LP 864 ones of kernel_vs_plain (`kv`).
    Returns the launches, the comparisons and the shapes."""
    from particlesmc_tpu_torch.core.energy import initialize_energy, total_energy_dense
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    # the untrimmed main path is unchanged (its kernel launches: phase_library)
    untrimmed = untrimmed_profile["device_launches"]
    assert untrimmed == MAIN_DEVICE_LAUNCHES, f"untrimmed block: {untrimmed} device launches"
    pos, species = lattice_config(N)
    table = T.KobAndersen(torch.float32, device)
    st = make_system(pos, species, DENSITY, TEMPERATURE, dtype=torch.float32, device=device)
    st = initialize_energy(st, table, energy_dtype=torch.float64).repeat(CHAINS)
    box0 = st.box[0].double().cpu().numpy()
    spec = CB.make_cb_spec(box0, table.max_cutoff, N, CAP)
    trim_k = CB.auto_trim_k(spec, box0, table.max_cutoff, N)  # what trim = "auto" reads
    assert trim_k == 512, trim_k
    pool = (MB.displacement(SIGMA),)
    params = MB.init_pool_params(pool, torch.float32, device)
    hs = CB.build_hyper_sweep_fn(spec, table, N, inner=INNER, sweeps=REBIN, pool=pool, trim_k=trim_k,
                                 trim_rcut=table.max_cutoff)
    cb = CB.init_cb_state(st, spec, seed=0, n_moves=1)
    cb = hs(cb, params)  # warm-up block
    torch.cuda.synchronize()
    att0, acc0, skip0 = int(cb.attempted.sum()), int(cb.accepted.sum()), int(cb.skipped.sum())
    cb_cuda.disp_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRIM_TIMED_BLOCKS):
        cb = hs(cb, params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cb_cuda.disp_substep.launches
    expected, _ = expected_launches(pool, spec, INNER, N, REBIN * TRIM_TIMED_BLOCKS)
    assert launches == expected > 0, f"{launches} kernel launches, expected {expected}"
    attempted = int(cb.attempted.sum()) - att0
    acceptance = (int(cb.accepted.sum()) - acc0) / max(1, attempted)
    assert 0.0 < acceptance < 1.0, f"acceptance {acceptance}"
    skipped = int(cb.skipped.sum()) - skip0
    profile = profile_block(lambda: hs(cb, params))
    e_dense = total_energy_dense(
        cb.system.position[:2].double(), cb.system.species[:2], cb.system.box[:2].double(), table.astype(torch.float64)
    )
    gap = float((cb.system.energy[:2] - e_dense).abs().max()) / N
    assert bool(torch.isfinite(cb.system.position).all()), "non-finite positions"
    assert gap <= 1e-5, f"ledger differs from the dense recompute by {gap} per particle"

    table64 = T.KobAndersen(torch.float64, device)
    args64 = substep_inputs(bench_system(device), table64, spec, INNER, SIGMA)
    pos_t, sp_t, _, ok = hs.plan.compact(args64[0], args64[1], None, args64[5], args64[6])
    assert bool(ok.all()), "the comparison's lanes overflow trim_k"
    args_t = (pos_t.contiguous(), sp_t.contiguous()) + tuple(args64[2:])
    kinds = T.kinds_present(table64)
    cb_cuda.disp_substep.launches = 0
    out = {}
    for dtype in (torch.float64, torch.float32):
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = compare(tuple(t.to(dtype) for t in args_t), kinds, cap=CAP)
        out[key]["untrimmed_kernel_ms"] = kv[key]["kernel_ms"]
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    shapes = _shapes(args_t, cap=CAP)
    assert shapes["LP"] == CAP + trim_k == 544
    ranges = profile["ranges_ms"]
    emit({
        "phase": "library_trim", "N": N, "chains": CHAINS, "precision": "mixed", "trim": "auto",
        "trim_k": trim_k, "LP": CAP + trim_k, "untrimmed_LP": 27 * CAP, "inner": INNER, "sweeps_per_rebin": REBIN,
        "timed_blocks": TRIM_TIMED_BLOCKS, "seconds": elapsed, "sweeps_per_s": attempted / N / elapsed,
        "block_ms": 1e3 * elapsed / TRIM_TIMED_BLOCKS, "acceptance": acceptance, "launches": launches,
        "launches_per_block": launches // TRIM_TIMED_BLOCKS, "skipped": skipped,
        "skipped_per_block_and_chain": skipped / (TRIM_TIMED_BLOCKS * CHAINS),
        "compaction_device_ms": ranges.get(CB.TRIM_RANGE, 0.0), "ledger_gap_per_particle": gap,
        "profiled_block": profile, "untrimmed_device_launches": untrimmed_profile["device_launches"],
        "untrimmed_stream_syncs": untrimmed_profile["stream_syncs"], "shapes": shapes,
        "kernel_ms_lp544": {k: v["kernel_ms"] for k, v in out.items()},
        "kernel_ms_lp864": {k: v["kernel_ms"] for k, v in kv.items() if k in ("f32", "f64")},
    })
    emit({"phase": "kernel_vs_plain", "path": "library_trim", "shapes": shapes, **out})
    return launches, out, shapes


# --- one system over slabs (parallel/spatial.py) on one card ---------------
SP_NC, SP_SIGMA, SP_INNER, SP_SWEEPS, SP_TIMED, SP_SLABS = 32, 0.06, 48, 2, 3, (2, 4)


def cell_energy(st, k=None):
    """Float64 particle energies from the sequential backend's cell list
    (core/neighbours.py: its own binning and minimum-image distances, no code
    of the checkerboard grid): particles k [B, R] against the candidates of
    their 3^d cells -> [B, R]; without `k`, each chain's total energy [B]
    (every particle's, summed and halved). The O(N^2) recompute's sums at
    N = 633,000 without its N^2 pairs; phase_library_spatial holds them
    against particle_energy_nogather (all N) on a sample."""
    from particlesmc_tpu_torch.core import neighbours as NB
    from particlesmc_tpu_torch.core.energy import particle_energy, take
    from particlesmc_tpu_torch.models import tables as T

    dev = st.position.device
    table = T.KobAndersen(torch.float64, dev)
    pos, box = st.position.double(), st.box.double()
    B, n, d = pos.shape
    spec = NB.make_spec(box[0].cpu().numpy(), table.max_cutoff, n)
    clist = NB.build_cell_list(pos, box, spec)
    assert not bool(clist.overflow.any()), "the recompute's cell list overflows its buckets"

    def energies(kk):
        cands = NB.candidates_around(take(pos, kk), box, clist, spec)
        return particle_energy(kk, cands, pos, st.species, box, table)

    if k is not None:
        return energies(k)
    rows = max(1, (1 << 23) // (B * 3**d * spec.cap))
    iota = torch.arange(n, device=dev)
    total = torch.zeros(B, dtype=torch.float64, device=dev)
    for k0 in range(0, n, rows):
        total += energies(iota[k0:k0 + rows].expand(B, -1)).sum(dim=-1)
    return total / 2


def sampled_energy_gap(st, count=1024, seed=0):
    """The largest difference between cell_energy and the all-N sum
    (particle_energy_nogather, float64) over `count` particles drawn from a
    seed: a candidate the cell list missed shows here."""
    from particlesmc_tpu_torch.core.energy import particle_energy_nogather
    from particlesmc_tpu_torch.models import tables as T

    dev = st.position.device
    table = T.KobAndersen(torch.float64, dev)
    pos, box = st.position.double(), st.box.double()
    B, n = st.species.shape
    gen = torch.Generator().manual_seed(seed)
    k = torch.randperm(n, generator=gen)[:count].to(dev).expand(B, -1)
    rows = max(1, (1 << 23) // (B * n))
    dense = torch.cat([particle_energy_nogather(k[:, r:r + rows], pos, st.species, box, table)
                       for r in range(0, k.shape[1], rows)], dim=1)
    return float((cell_energy(st, k) - dense).abs().max())


def spatial_system(device, dtype, temperature=TEMPERATURE):
    """One KA-LJ system, 3D, rho 1.2, in a cubic box of side 32 * 2.5 * 1.01
    (a 32^3 grid at the cutoff; N = 633,017), from a jittered lattice; the
    ledger (float64) from cell_energy."""
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.moves import checkerboard as CB

    L = SP_NC * 2.5 * 1.01
    n = int(round(DENSITY * L**3))
    pos, species = lattice_config(n, density=n / L**3)
    st = make_system(pos, species, DENSITY, temperature, box=np.full(3, L), dtype=dtype, device=device)
    spec = CB.make_cb_spec(np.full(3, L), 2.5, n)
    assert spec.ncells == (SP_NC,) * 3, spec
    return st.replace(energy=cell_energy(st)), spec


def _spatial_run(fn, st, spec, pool, params):
    """One call of `fn` from a fresh state, with its kernel launches (the
    count set to 0 just before and read just after)."""
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    cb = CB.init_cb_state(st, spec, seed=0, n_moves=len(pool))
    cb_cuda.disp_substep.launches = 0
    cb = fn(cb, params)
    torch.cuda.synchronize()
    return cb, cb_cuda.disp_substep.launches


def phase_library_spatial(device):
    """One KA-LJ system of N = 633,017 (1 chain, the case the spatial path
    exists for), sigma 0.06, inner 48, 2 sweeps per call, f64 and mixed:
    P = 2 and 4 slabs on one card (a device list repeating cuda:0) against
    the unsharded run on the same generator (f64: accepts, species and
    positions bitwise; mixed: the f32 limits), then Displacement (0.8) +
    DoubleUniform 1<->2 (0.2) at T 5.0 the same way; sweeps/s at P = 1
    (unsharded), 2 and 4; kernel launches per call (P per kernel run per
    colour); a traced call at P = 4 for the halo exchange's device ms; the
    ledgers against cell_energy; the kernel against its plain version at a
    P = 2 slab's shapes (f64). The nccl transport needs several cards and
    is not run here."""
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB
    from particlesmc_tpu_torch.parallel import mesh as PM
    from particlesmc_tpu_torch.parallel import spatial as SP

    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.core.state import make_system

    # the recompute itself against the O(N^2) one, on the main path's start
    pos, species = lattice_config(N)
    st10 = make_system(pos, species, DENSITY, TEMPERATURE, device=device)
    e_dense = total_energy_dense(st10.position, st10.species, st10.box, T.KobAndersen(torch.float64, device))
    cell_rel = float(((cell_energy(st10) - e_dense).abs() / e_dense.abs()).max())
    assert cell_rel <= 1e-12, f"cell_energy differs from the dense recompute by {cell_rel} relative"
    out, launches_main = {"cell_energy_vs_dense_rel": cell_rel}, None
    cases = (("f64", torch.float64, TEMPERATURE, (MB.displacement(SP_SIGMA),)),
             ("mixed", torch.float32, TEMPERATURE, (MB.displacement(SP_SIGMA),)),
             ("f64_swap", torch.float64, 5.0, (MB.displacement(SP_SIGMA, 0.8), MB.discrete_swap(0, 1, 0.2))))
    for name, dtype, temp, pool in cases:
        st, spec = spatial_system(device, dtype, temp)
        n = st.n_particles
        table = T.KobAndersen(dtype, device)
        params = MB.init_pool_params(pool, dtype, device)
        fns = {1: CB.build_hyper_sweep_fn(spec, table, n, inner=SP_INNER, sweeps=SP_SWEEPS, pool=pool)}
        for P in SP_SLABS:
            fns[P] = SP.build_spatial_hyper_sweep_fn(spec, table, n, PM.make_mesh(device=[device] * P),
                                                    inner=SP_INNER, sweeps=SP_SWEEPS, pool=pool)
        ref, ref_launches = _spatial_run(fns[1], st, spec, pool, params)
        per_kernel_run, runs = expected_launches(pool, spec, SP_INNER, n, SP_SWEEPS)
        assert ref_launches == per_kernel_run > 0, (ref_launches, per_kernel_run)
        res = {"N": n, "cells": list(spec.ncells), "cap": spec.cap, "n_active": spec.n_active,
               "temperature": temp, "pool": [f"{m.action}/{m.policy}" for m in pool], "launches": {1: ref_launches}}
        assert not bool(ref.overflow.any()), "the unsharded run overflowed a bucket"
        for P in SP_SLABS:
            sp_cb, lp = _spatial_run(fns[P], st, spec, pool, params)
            assert lp == P * per_kernel_run, f"P = {P}: {lp} kernel launches, expected {P * per_kernel_run}"
            res["launches"][P] = lp
            same = torch.equal(ref.accepted, sp_cb.accepted) and torch.equal(ref.system.species, sp_cb.system.species)
            pos_err = float((ref.system.position - sp_cb.system.position).abs().max())
            if dtype == torch.float64:
                assert same and pos_err == 0.0, f"P = {P}: the slabs differ from the unsharded run ({pos_err})"
            else:
                acc_diff = abs(int(ref.accepted.sum()) - int(sp_cb.accepted.sum())) / max(1, int(ref.accepted.sum()))
                assert acc_diff <= 1e-3 and pos_err <= 1e-5, (acc_diff, pos_err)
            res[f"P{P}"] = {"bitwise": same and pos_err == 0.0, "position_max_abs_err": pos_err,
                            "energy_rel_diff": float(((ref.system.energy - sp_cb.system.energy).abs()
                                                      / ref.system.energy.abs()).max())}
        gap = float((sp_cb.system.energy - cell_energy(sp_cb.system)).abs().max()) / n
        assert gap <= (1e-5 if dtype == torch.float32 else 1e-9), f"ledger differs from the recompute by {gap}"
        sample_gap = sampled_energy_gap(sp_cb.system)
        assert sample_gap <= 1e-9, f"the cell list's particle energies differ from the all-N sums by {sample_gap}"
        res["ledger_gap_per_particle"] = gap
        res["sampled_particle_energy_gap"] = sample_gap
        res["acceptance"] = move_acceptance(sp_cb)
        assert all(0.0 < a < 1.0 for a in res["acceptance"]), res["acceptance"]
        if name != "f64_swap":
            rate = {}
            for P, fn in fns.items():
                cb = CB.init_cb_state(st, spec, seed=1, n_moves=len(pool))
                cb = fn(cb, params)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SP_TIMED):
                    cb = fn(cb, params)
                torch.cuda.synchronize()
                rate[P] = SP_SWEEPS * SP_TIMED / (time.perf_counter() - t0)
            res["sweeps_per_s"] = rate
            prof = profile_block(lambda: fns[SP_SLABS[-1]](cb, params))
            res[f"profiled_call_P{SP_SLABS[-1]}"] = prof
            res["halo_device_ms_per_call"] = prof["ranges_ms"].get(SP.HALO_RANGE, 0.0)
            res["profiled_call_P1"] = profile_block(lambda: fns[1](cb, params))
        if name == "f64":
            launches_main = res["launches"]
        out[name] = res
    # the kernel against its plain version at a P = 2 slab's shapes
    st, spec = spatial_system(device, torch.float64)
    table64 = T.KobAndersen(torch.float64, device)
    args = substep_inputs(st, table64, spec, SP_INNER, SP_SIGMA)
    A_l = spec.n_active // SP_SLABS[0]
    pos, sp, up, dl, thr, lo, hi, tab = args
    args = (pos[:, :, :A_l].contiguous(), sp[:, :A_l].contiguous(), up[..., :A_l].contiguous(),
            dl[..., :A_l].contiguous(), thr[..., :A_l].contiguous(), lo[:, :A_l].contiguous(),
            hi[:, :A_l].contiguous(), tab)
    cb_cuda.disp_substep.launches = 0
    kv = compare(args, T.kinds_present(table64))
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    shapes = _shapes(args)
    emit({"phase": "library_spatial", "sigma": SP_SIGMA, "inner": SP_INNER, "sweeps_per_call": SP_SWEEPS,
          "slabs": list(SP_SLABS), "mesh": "device list repeating cuda:0", **out})
    emit({"phase": "kernel_vs_plain", "path": "library_spatial", "shapes": shapes, "f64": kv})
    return launches_main, kv, shapes


def phase_launch_plan(paths):
    """The launcher's cells (warps) per block and dynamic shared memory per
    block at each path's shapes."""
    from particlesmc_tpu_torch.moves import cb_cuda

    plans = []
    for path, dtype, sh in paths:
        cpb, smem = cb_cuda.launch_plan(dtype, sh["d"], sh["S"], sh["LP"], sh["inner"])
        plans.append({
            "path": path, "dtype": str(dtype).replace("torch.", ""), "cells_per_block": cpb,
            "threads_per_block": 32 * cpb, "smem_bytes_per_block": smem,
            "grid": [-(-sh["A"] // cpb), sh["B"]],
        })
    emit({"phase": "launch_plan", "plans": plans})
    return plans


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import particlesmc_tpu_torch  # fails outside the checkout

    pkg = os.path.dirname(os.path.abspath(particlesmc_tpu_torch.__file__))
    if pkg != os.path.join(ROOT, "particlesmc_tpu_torch"):
        raise RuntimeError(f"particlesmc_tpu_torch was imported from {pkg}, not from this checkout")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    wall = {}

    def timed(fn, *args):
        """fn(*args), its wall seconds kept under the phase's name."""
        t0 = time.perf_counter()
        out = fn(*args)
        wall[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        return out

    name, smi = timed(phase_device)
    timed(phase_build)
    kv, lib_shapes = timed(phase_kernel_vs_plain, device)
    launches, lib_cb, lib_profile = timed(phase_library, device)
    sim, cli_launches = timed(phase_cli, device)
    kc, cli_shapes = timed(phase_cli_kernel_vs_plain, sim)
    swap_launches, ks, swap_shapes = timed(phase_cli_swap, device)
    bias_launches, bias_run = timed(phase_library_energy_bias, device)
    kb, bias_shapes = timed(phase_bias_kernel_vs_plain, *bias_run)
    timed(phase_cli_smart, device)
    timed(phase_library_molecular, device)
    timed(phase_library_sequential, device)
    timed(phase_library_sequential_swap, device)
    timed(phase_library_sequential_molecular, device)
    temper_launches, kt, temper_shapes = timed(phase_cli_tempering, device)
    pgmc_launches, kp, pgmc_shapes = timed(phase_library_pgmc, device)
    timed(phase_library_pgmc_sequential, device)
    timed(phase_checkpoint, device)
    timed(phase_analysis, device, lib_cb)
    del lib_cb
    trim_launches, ktr, trim_shapes = timed(phase_library_trim, device, kv, lib_profile)
    spatial_launches, ksp, spatial_shapes = timed(phase_library_spatial, device)
    phase_launch_plan([
        ("library", torch.float32, lib_shapes),
        ("library", torch.float64, lib_shapes),
        ("cli", torch.float64, cli_shapes),
        ("cli_swap", torch.float32, swap_shapes),
        ("library_energy_bias", torch.float64, bias_shapes),
        ("cli_tempering", torch.float64, temper_shapes),
        ("library_pgmc", torch.float64, pgmc_shapes),
        ("library_trim", torch.float32, trim_shapes),
        ("library_trim", torch.float64, trim_shapes),
        ("library_spatial", torch.float64, spatial_shapes),
    ])
    emit({"phase": "wall_seconds", **wall, "total": sum(wall.values())})
    f32 = kv["f32"]
    keep = ("variant", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "booked_max_rel_err")
    emit({"kernels": [{
        "name": "cb_disp_substep",
        "route": "cuda",
        "source": "particlesmc_tpu_torch/csrc/cb_disp_substep.cu",
        "replaces": "particlesmc_tpu/moves/cb_pallas.py:155",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
        "design": "warp per cell, compacted neighbour lanes, kind-specialised",
        "variant": {"library": f32["variant"], "cli": kc["variant"]},
        "dtype": "float32",
        "f64": {k: kv["f64"][k] for k in keep},
        "generic_variant_ms": {"f32": kv["f32_generic"]["kernel_ms"], "f64": kv["f64_generic"]["kernel_ms"]},
        "cli_f64": {"launches": cli_launches, **{k: kc[k] for k in keep}},
        "cli_swap_f32": {"launches": swap_launches, **{k: ks[k] for k in keep}},
        "library_energy_bias_f64": {"launches": bias_launches, **{k: kb[k] for k in keep}, "sweep": kb["sweep"]},
        "cli_tempering_f64": {"launches": temper_launches, **{k: kt[k] for k in keep}},
        "library_pgmc_f64": {"launches": pgmc_launches, **{k: kp[k] for k in keep}, "sweep": kp["sweep"]},
        "library_trim_f32": {"launches": trim_launches, **{k: ktr["f32"][k] for k in keep}},
        "library_trim_f64": {"launches": trim_launches, **{k: ktr["f64"][k] for k in keep}},
        "library_spatial_f64": {"launches": spatial_launches, **{k: ksp[k] for k in keep}},
        "card": smi,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

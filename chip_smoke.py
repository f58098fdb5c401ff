"""Smoke test of particlesmc_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version at the shapes of the main path, then drives the
main path through the two entry points a user calls: the library (N = 10,000
Kob-Andersen LJ in 3D, 256 chains, mixed precision, 48 sub-moves per cell
and colour, 16 sweeps per rebin) and the TOML CLI on a shortened copy of
examples/movie/params.toml (2D JBB, N = 1290, float64), and holds the kernel
against its plain version a second time at the CLI path's shapes, on the CLI
run's final state. Every phase prints one JSON line; any failure raises and the exit code is not 0. The last line
is {"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script fails before printing a result.
"""

from __future__ import annotations

import json
import math
import os
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


def phase_build():
    from particlesmc_tpu_torch.moves import cb_cuda

    cached = any(cb_cuda.BUILD_ROOT.glob("*/libcb_disp_substep.so"))
    t0 = time.perf_counter()
    lib = cb_cuda.build_library()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "cached": cached, "library": str(lib.relative_to(ROOT)), "ptxas": ptxas})


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
    packed_pos, packed_sp = CB.extract_colour(padded, spec, c)
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


def needed_ops(args, acc):
    """Operations the function needs on these inputs, replaying the sub-moves
    with the accepts `acc` [B, A, inner]. Only a sub-move of an occupied cell
    whose proposal stays inside the cell needs its energy change; it needs,
    for every valid non-mover lane, two r^2 (3d - 1 each), two cutoff
    compares, the du subtract and its accumulate, and the potential's body
    (body_ops) for each of r^2_old and r^2_new that lies within the pair's
    cutoff."""
    packed_pos, packed_sp, up, dl, _, lo, hi, tab = args
    B, d, A, LP = packed_pos.shape
    inner = up.shape[1]
    cap = LP // 3**d
    S = tab.shape[-1]
    dev = packed_pos.device
    body = body_ops(tab).reshape(-1)
    rcut2 = tab[4].reshape(-1)
    live = (tab[0] != 0).reshape(-1)
    pos = packed_pos.clone()
    valid = packed_sp >= 0
    sp = torch.clamp_min(packed_sp, 0).long()
    occ = valid[..., :cap].sum(dim=-1)
    lanes = torch.arange(LP, device=dev)
    per_lane = 2 * (3 * d - 1) + 2 + 2
    ops = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(inner):
        r = torch.floor(up[:, k] * occ.to(pos.dtype)).long().clamp(0, LP - 1)  # [B, A]
        x_a = torch.gather(pos, 3, r[:, None, :, None].expand(B, d, A, 1))[..., 0]
        x_new = x_a + dl[:, k]
        in_cell = (occ > 0) & ((x_new >= lo) & (x_new < hi)).all(dim=1)
        pick = lanes == r[..., None]
        need = valid & ~pick & in_cell[..., None]
        pair = torch.gather(sp, 2, r[..., None]) * S + sp
        r2o = ((pos - x_a[..., None]) ** 2).sum(dim=1)
        r2n = ((pos - x_new[..., None]) ** 2).sum(dim=1)
        near = need & live[pair]
        ops += per_lane * need.sum()
        ops += (body[pair] * ((near & (r2o <= rcut2[pair])).long() + (near & (r2n <= rcut2[pair])).long())).sum()
        moved = (pick & acc[..., k].bool()[..., None])[:, None]
        pos = torch.where(moved, x_new[..., None], pos)
    return float(ops)


def bound_ms(args, outs, dtype):
    """Least time the card could take: the larger of the bytes moved (each
    input read once, each output written once) over the HBM rate and the
    operations these inputs need (needed_ops) over the peak rate of their
    type."""
    ops = needed_ops(args, outs[2])
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


# booked ΔE of a (chain, cell): kernel against plain version, relative to
# max(1, |plain|) (energies are O(1) in units of epsilon). In float32 the
# sum order alone moves it by a few 1e-5 at the library path's shapes.
BOOKED_RTOL = {torch.float64: 1e-12, torch.float32: 5e-4}


def compare(args):
    """The kernel against its plain version on `args`: asserts agreement and
    returns the errors, both times and the bound."""
    from particlesmc_tpu_torch.moves import cb_cuda

    dtype = args[0].dtype
    k_out = cb_cuda.disp_substep(*args)
    p_out = cb_cuda.disp_substep_plain(*args)
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
    kernel_ms = _time_ms(lambda: cb_cuda.disp_substep(*args), runs=20, warmup=3)
    plain_ms = _time_ms(lambda: cb_cuda.disp_substep_plain(*args), runs=3)
    b_ms, b_by, ops = bound_ms(args, k_out, dtype)
    return dict(
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ops=ops,
        max_abs_err=max_err, booked_max_abs_err=booked_err, booked_max_rel_err=booked_rel,
        accept_count_differ_frac=differ_frac, accepted=n_acc,
    )


def _shapes(args):
    B, d, A, LP = args[0].shape
    return {"B": B, "d": d, "A": A, "cap": LP // 3**d, "LP": LP, "inner": args[2].shape[1]}


def phase_kernel_vs_plain(device):
    """The kernel against its plain version at the library path's shapes,
    in float64 and float32."""
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import cb_cuda
    from particlesmc_tpu_torch.moves import checkerboard as CB

    st = bench_system(device)
    table = T.KobAndersen(torch.float64, device)
    spec = CB.make_cb_spec(st.box[0].cpu().numpy(), table.max_cutoff, N, CAP)
    args64 = substep_inputs(st, table, spec, INNER, SIGMA)
    cb_cuda.disp_substep.launches = 0
    out = {}
    for dtype in (torch.float64, torch.float32):
        out["f64" if dtype == torch.float64 else "f32"] = compare(tuple(t.to(dtype) for t in args64))
    launches = cb_cuda.disp_substep.launches
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    emit({"phase": "kernel_vs_plain", "path": "library", "shapes": _shapes(args64),
          "launches": launches, **out})
    return out


def profile_block(run_block):
    """Device time of one block by torch.profiler: the kernel's share, the
    PyTorch glue's, and the device's idle share of the block's span."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_block()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert evs, "the profiler saw no device activity"
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    span = (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) / 1e3
    busy = sum(by_name.values())
    kernel = sum(v for k, v in by_name.items() if "disp_substep_kernel" in k)
    top = sorted(((v, k) for k, v in by_name.items() if "disp_substep_kernel" not in k), reverse=True)
    return {
        "span_ms": span, "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
        "kernel_ms": kernel, "glue_ms": busy - kernel, "device_launches": len(evs),
        "top_glue": [[k[:80], v] for v, k in top[:5]],
    }


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
    return launches


def phase_cli(device):
    """The main path through the TOML CLI (run on the card by default): a
    shortened examples/movie run."""
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.energy import total_energy_dense
    from particlesmc_tpu_torch.moves import cb_cuda

    src = os.path.join(ROOT, "examples", "movie", "params.toml")
    with open(src) as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        frame = os.path.join(ROOT, "examples", "movie", "inputframe.exyz")
        steps = 200
        for old, new in (
            ('config = "inputframe.exyz"', f'config = "{frame}"'),
            ("steps = 50000", f"steps = {steps}"),
            ('output_path = "./"', f'output_path = "{tmp}"'),
            ("linear_interval = 500", "linear_interval = 50"),
            ("linear_interval = 1000", "linear_interval = 100"),
        ):
            assert old in text, f"{old!r} not in {src}"
            text = text.replace(old, new)
        params = os.path.join(tmp, "params.toml")
        with open(params, "w") as f:
            f.write(text)
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


def phase_cli_kernel_vs_plain(sim):
    """The kernel against its plain version at the CLI path's shapes: the
    CLI run's final state, grid, pair table, `inner` and sigma, in its
    float64."""
    from particlesmc_tpu_torch.moves import cb_cuda

    sigma = dict(sim.pool[0].params)["sigma"]
    args = substep_inputs(sim.mc.system, sim.chains.table, sim.cb_spec, sim.inner, sigma)
    cb_cuda.disp_substep.launches = 0
    out = compare(args)
    launches = cb_cuda.disp_substep.launches
    cb_cuda.disp_substep.launches = 0  # comparison launches do not count
    emit({"phase": "kernel_vs_plain", "path": "cli", "shapes": _shapes(args),
          "launches": launches, "f64": out})
    return out


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
    name, smi = phase_device()
    phase_build()
    kv = phase_kernel_vs_plain(device)
    launches = phase_library(device)
    sim, cli_launches = phase_cli(device)
    kc = phase_cli_kernel_vs_plain(sim)
    f32 = kv["f32"]
    keep = ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "booked_max_rel_err")
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
        "dtype": "float32",
        "f64": {k: kv["f64"][k] for k in keep},
        "cli_f64": {"launches": cli_launches, **{k: kc[k] for k in keep}},
        "card": smi,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

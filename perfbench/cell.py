"""One run of one cell of the benchmark.

Set-up, from the seed and on the run's device: the start of every chain
(generate.py), the energy ledger, a burn-in Simulation run, a timed probe
Simulation run that sizes the window, and the window's Simulation with the
traffic's outputs. The window is one `Simulation.run()`, the entry that the
library and the CLI run, over as many sweeps as fill `seconds` at the
probe's pace, outputs included. After it closes: with `trace`, a profiled
slice (a short Simulation on the window's end state, run once warm and once
under torch.profiler) for the per-layer metrics; then the check against the
plain reference (`judge`).

The program under test (particlesmc_tpu_torch) gives the system, its state
and its counters; everything that measures or judges it lives here.
"""

from __future__ import annotations

import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import generate, spec, trace
from perfbench.reference.energy import total_energy

# positions and ledger of each precision the traffic may state
PRECISIONS = {
    "mixed": (torch.float32, torch.float64),
    "float32": (torch.float32, torch.float32),
    "float64": (torch.float64, torch.float64),
}


# stretches of the window whose drift the check takes: bounds the reference's
# energy evaluations however fast the program runs
MAX_STRETCHES = 8


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def seeds(seed: int, k: int) -> list:
    """k independent seeds below 2^63 from the run's seed (any size)."""
    words = np.random.SeedSequence(int(seed)).generate_state(k, dtype=np.uint64)
    return [int(w >> np.uint64(1)) for w in words]


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Watch:
    """What the window leaves for the metrics and the check, taken where the
    host sees the state anyway: at the engine's output events (StoreCallbacks
    calls it) and at the window's close.

    - Every chain's unwrapped displacement since the window began:
      minimum-image displacements summed between consecutive host returns,
      so that no box crossing is lost at any pace (msd_per_s). As a callback
      it records each chain's mean squared displacement so far.
    - For the sampled chains, a snapshot at each return: positions,
      species, ledger, and attempted and accepted moves per move of the
      pool, [k, M] (what `judge` compares)."""

    __name__ = "msd"

    def __init__(self, sample):
        self.sample = sample

    def begin(self, mc):
        position = mc.system.position
        self.prev = position.double().clone()
        self.disp = torch.zeros_like(self.prev)
        self.box = mc.system.box.double()[:, None, :]
        self.times = [time.perf_counter()]
        self.snaps = [self.snapshot(mc)]

    def snapshot(self, mc) -> dict:
        s = self.sample
        return dict(
            position=mc.system.position[s].cpu(), species=mc.system.species[s].cpu(),
            ledger=mc.system.energy[s].double().cpu(), attempted=mc.attempted[s].cpu(), accepted=mc.accepted[s].cpu(),
        )

    def update(self, mc):
        position = mc.system.position
        dx = position.double() - self.prev
        self.disp += dx - torch.round(dx / self.box) * self.box
        self.prev = position.double().clone()
        self.times.append(time.perf_counter())
        self.snaps.append(self.snapshot(mc))

    def per_chain(self):
        return (self.disp * self.disp).sum(dim=-1).mean(dim=-1)

    def __call__(self, sim):
        self.update(sim.mc)
        return self.per_chain().cpu().numpy()


def program(cfg: dict, traffic: dict, device, sigma_scale: float = 1.0):
    """The program's pair table and move pool for this cell, as a user of
    the library builds them. `sigma_scale` widens every move's `sigma` (a
    planted fault, for the control's readings)."""
    from particlesmc_tpu_torch.models import tables
    from particlesmc_tpu_torch.moves import base

    pdt = PRECISIONS[traffic["precision"]][0]
    table = getattr(tables, cfg["system"]["model"])(pdt, device)
    pool = tuple(
        getattr(base, m["move"])(**{k: v * sigma_scale if k == "sigma" else v for k, v in m["args"].items()})
        for m in traffic["pool"]
    )
    return table, pool


def simulation(state, table, pool, cfg, seed, steps, path, outputs=(), sweepstep=None):
    """A Simulation of `steps` sweeps from `state`, as the library runs one."""
    from particlesmc_tpu_torch.engine.simulation import Simulation
    from particlesmc_tpu_torch.io.loader import Chains

    sampler = cfg["sampler"]
    chains = Chains(
        states=state, table=table, list_type=sampler["list_type"],
        list_parameters=dict(sampler.get("list_parameters", {})), n_chains=state.n_chains,
    )
    metro = dict(algorithm="Metropolis", pool=pool, seed=seed, parallel_moves=bool(sampler["parallel_moves"]))
    if sweepstep is not None:
        metro["sweepstep"] = int(sweepstep)
    return Simulation(chains, [metro, *outputs], int(steps), path=path)


def counter_mismatch(attempted, skips, steps: int, n: int) -> int:
    """Chains whose attempted moves in the window a sound run cannot give,
    whatever the program's schedule: every chain without a skipped block
    makes the same whole number c >= N of attempts per step (one step is a
    sweep; the count most of them share is the one held), and a chain with
    skipped blocks makes fewer, a whole number of steps fewer. Where every
    chain skipped, none can be checked: all count."""
    clean = skips == 0
    B = int(attempted.numel())
    if not bool(clean.any()):
        return B
    full = int(torch.mode(attempted[clean]).values)
    c = full // steps
    if full % steps or c < n:
        return B
    ok = torch.where(clean, attempted == full, (attempted < full) & (attempted % c == 0))
    return int((~ok).sum())


def blocks_of(cfg: dict, steps: int, times) -> int:
    """Rebin blocks (sweeps on the sequential kernel) that the engine runs
    between the window's output events."""
    sampler = cfg["sampler"]
    if not sampler["parallel_moves"]:
        return steps
    rebin = int(sampler["list_parameters"]["rebin_every"])
    edges = sorted(set(int(t) for t in times) | {0, steps})
    return sum(-(-(b - a) // rebin) for a, b in zip(edges[:-1], edges[1:]))


def composition(species, S: int):
    return torch.zeros((species.shape[0], S), dtype=torch.int64, device=species.device).scatter_add_(
        1, species, torch.ones_like(species)
    )


def ledger_drift(potential, snaps: list, box) -> float:
    """The root mean square, over the chains and the stretches between
    consecutive snapshots, of the gap between the ledger's change and the
    float64 reference's change of the total energy, per square root of the
    chain's attempted moves in the stretch (the ledger's rounding and the
    energy changes' errors add up as a random walk over its moves; each
    stretch is one independent step of that walk). Snapshots: dicts of
    position [k, N, d], species [k, N], ledger [k] and attempted [k, M];
    each snapshot's energy is taken with its own species, which swaps
    change."""
    dev = box.device
    ref = [total_energy(sn["position"].to(dev), sn["species"].to(dev), box, potential).cpu() for sn in snaps]
    gaps = []
    for (a, ra), (b, rb) in zip(zip(snaps[:-1], ref[:-1]), zip(snaps[1:], ref[1:])):
        moves = (b["attempted"] - a["attempted"]).sum(dim=-1).double()
        gap = (b["ledger"] - a["ledger"]) - (rb - ra)
        gaps.append((gap / moves.clamp_min(1.0).sqrt())[moves > 0])
    g = torch.cat(gaps)
    return float(g.square().mean().sqrt()) if g.numel() else 0.0


def displacements(trf: dict) -> list:
    """The pool's moves that displace a particle (a swap or a flip moves
    none), by their index in the program's counters."""
    return [m for m, mv in enumerate(trf["pool"]) if mv["move"].startswith("displacement")]


def frozen_excess(first: dict, last: dict, n: int, moving: list) -> float:
    """The largest excess, over the chains, of the share of particles whose
    position did not change over the window above the share that the
    chain's own counters leave unmoved: with a attempted displacements at
    acceptance p, a particle is picked about a / N times and stays put with
    probability about exp(-a p / N), the chain's accepted displacements
    (the counters of the moves `moving`) over N. A step that keeps a chain's
    positions while its counters advance reads about 1."""
    att = (last["attempted"] - first["attempted"])[:, moving].sum(dim=-1).double()
    acc = (last["accepted"] - first["accepted"])[:, moving].sum(dim=-1).double()
    expected = torch.exp(-acc / n)  # a p / N = accepted moves / N
    same = (first["position"] == last["position"]).all(dim=-1).double().mean(dim=-1)
    return float((same - torch.where(att > 0, expected, torch.ones_like(expected))).max())


def reference_sampler(name: str):
    """The plain reference sampler module reference/<name>.py, found by the
    traffic's `reference_sampler`: acceptance(cfg, trf, position, species,
    box, steps, generator) -> (attempted, accepted), summed over the chains,
    as numbers (a pool of one move) or one per move of the pool. A pool that
    the named sampler does not run brings a sampler of its own."""
    return spec.load_module(Path(__file__).resolve().parent / "reference" / f"{name}.py", f"perfbench_reference_{name}")


def acceptance_gap(cfg: dict, trf: dict, first: dict, last: dict, origin: dict, steps: int, box, seed: int) -> tuple:
    """The gap, for each move of the pool, between the sampled chains'
    acceptance of the move from snapshot `first` to `last` and the plain
    float64 reference sampler's over `steps` steps from the state of
    snapshot `origin`: the program's proposal, energy change and
    Metropolis-Hastings test of each move, all at once. A move that either
    side never attempted reads 1: the pool gives it a share, so a program
    that stops drawing it fails. Returns ([gap per move], [program's
    acceptance per move], [reference's per move])."""
    att = (last["attempted"] - first["attempted"]).sum(dim=0).double()
    acc = (last["accepted"] - first["accepted"]).sum(dim=0).double()
    prog = (acc / att.clamp_min(1.0)).tolist()
    g = torch.Generator(device=box.device)
    g.manual_seed(seed)
    ref_att, ref_acc = reference_sampler(trf["reference_sampler"]).acceptance(
        cfg, trf, origin["position"].to(box.device), origin["species"].to(box.device), box, int(steps), g,
    )
    ref_att, ref_acc = np.atleast_1d(ref_att), np.atleast_1d(ref_acc)
    ref = [float(c) / max(1, int(a)) for a, c in zip(ref_att, ref_acc)]
    gaps = [abs(p - r) if a > 0 and b > 0 else 1.0 for p, r, a, b in zip(prog, ref, att.tolist(), ref_att)]
    return gaps, prog, ref


def largest(gaps: list, moves: list) -> float:
    """The largest gap of the moves `moves` (0 where there are none)."""
    return max((gaps[m] for m in moves), default=0.0)


def share_z(trf: dict, first: dict, last: dict) -> float:
    """The largest gap, over the pool's moves, between how often the
    sampled chains attempted the move from snapshot `first` to `last` and
    how often the pool's probabilities say, in standard deviations of that
    binomial count (each chain draws its move at every step). A program
    that draws a move at another share than the pool states, or never,
    reads tens; a sound run a few at most."""
    att = (last["attempted"] - first["attempted"]).sum(dim=0).double()
    p = torch.tensor([float(mv["args"].get("probability", 1.0)) for mv in trf["pool"]], dtype=torch.float64)
    p = p / p.sum()
    n = att.sum()
    sd = (n * p * (1 - p)).sqrt()
    z = torch.where(sd > 0, (att - n * p).abs() / sd.clamp_min(1e-300), torch.zeros_like(sd))
    return float(z.max())


def acceptance_span(trf: dict, snaps: list) -> tuple:
    """(first, last, origin, steps) of the acceptance comparison:
    - where a snapshot past the first lies within `reference_steps` moves
      of the window's start, the program from the start to the last such
      snapshot and the reference from the window's start state over as
      many steps: where acceptance drifts over the run (a species
      arrangement that relaxes by swaps), only the same stretch of the run
      compares like with like;
    - else the program over the whole window and the reference over
      `reference_steps` steps from the window's end state."""
    cap = int(trf["reference_steps"])
    near = [sn for sn in snaps[1:] if 0 < moves_between(snaps[0], sn) <= cap]
    if near:
        return snaps[0], near[-1], snaps[0], moves_between(snaps[0], near[-1])
    return snaps[0], snaps[-1], snaps[-1], cap


def moves_between(a: dict, b: dict) -> int:
    """The most attempted moves of a sampled chain from snapshot a to b (on
    the sequential kernel every chain makes one per step)."""
    return int((b["attempted"] - a["attempted"]).sum(dim=-1).max())


def prepare(cell: spec.Cell, seed: int, seconds: float, device, plant=None) -> SimpleNamespace:
    """Set-up: the start from the seed, the ledger, the burn-in Simulation
    and the timed probe Simulation that sizes the window. `plant` (the
    control's readings only) may set `ledger`, a dtype in place of the
    traffic's (the program's own lower path), and `sigma_scale` or
    `temperature_scale`, planted faults of the program's moves."""
    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import SystemState

    cfg, trf = cell.config, cell.traffic
    sysc = cfg["system"]
    B, d = int(trf["chains"]), int(sysc["dim"])
    pdt, ldt = PRECISIONS[trf["precision"]]
    plant = dict(plant or {})
    ldt = plant.get("ledger", ldt)
    p = SimpleNamespace(seeds=dict(zip(("start", "burn", "probe", "window", "slice", "sample", "reference"), seeds(seed, 7))))
    marks = [("start", time.perf_counter())]
    g = generate.start(sysc, cfg["start"], B, p.seeds["start"], device)
    full = lambda v, *shape: torch.full(shape, float(v), dtype=pdt, device=device)  # noqa: E731
    state = SystemState(
        position=g["position"].to(pdt), species=g["species"], box=full(g["box_side"], B, d),
        temperature=full(float(sysc["temperature"]) * plant.get("temperature_scale", 1.0), B), density=full(sysc["density"], B), energy=full(0.0, B),
    )
    p.table, p.pool = program(cfg, trf, device, plant.get("sigma_scale", 1.0))
    state = initialize_energy(state, p.table, energy_dtype=None if ldt == pdt else ldt)
    synchronize(device)
    marks.append(("energy", time.perf_counter()))
    p.tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        burn = simulation(state, p.table, p.pool, cfg, p.seeds["burn"], trf["burn_in_steps"], f"{p.tmp}/burn")
        burn.run()
        marks.append(("burn-in", time.perf_counter()))
        probe = simulation(burn.mc.system, p.table, p.pool, cfg, p.seeds["probe"], trf["probe_steps"], f"{p.tmp}/probe")
        del burn
        synchronize(device)
        t0 = time.perf_counter()
        probe.run()
        synchronize(device)
        marks.append(("probe", time.perf_counter()))
    except BaseException:
        shutil.rmtree(p.tmp, ignore_errors=True)
        raise
    p.pace = int(trf["probe_steps"]) / (marks[-1][1] - t0)
    sampler = cfg["sampler"]
    quantum = int(sampler["list_parameters"].get("rebin_every", 1)) if sampler["parallel_moves"] else 1
    p.steps = max(1, round(p.pace * seconds / quantum)) * quantum
    p.start = probe.mc.system
    log("set-up seconds: " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks[:-1], marks[1:])))
    return p


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             plant=None) -> dict:
    """One run; returns the result's fields (the caller prints them).
    `plant` changes the program for the control's readings (`prepare`)."""
    cfg, trf = cell.config, cell.traffic
    sysc = cfg["system"]
    n, B = int(sysc["n"]), int(trf["chains"])
    S = len(sysc["species_fractions"])
    p = prepare(cell, seed, seconds, device, plant)
    try:
        steps, start = p.steps, p.start
        k = min(B, int(trf["reference_chains"]))
        sample = torch.as_tensor(np.sort(np.random.default_rng(p.seeds["sample"]).choice(B, k, replace=False)), device=device)
        times = np.arange(0, steps + 1, int(trf["output_interval"]), dtype=np.int64)
        watch = Watch(sample)
        outputs = [
            dict(algorithm="StoreCallbacks", callbacks=tuple(trf["callbacks"]) + (watch,), scheduler=times),
            dict(algorithm="StoreAcceptance", scheduler=times),
        ]
        sim = simulation(start, p.table, p.pool, cfg, p.seeds["window"], steps, f"{p.tmp}/window", outputs=outputs)
        # what the check reads at the window's start
        watch.begin(sim.mc)
        comp0 = composition(start.species, S)
        att0_chain = sim.mc.attempted.sum(dim=-1).clone()
        skip0 = getattr(sim.mc, "skipped", torch.zeros(B, dtype=torch.int64, device=device)).clone()
        att0 = int(sim.counters()[0].sum())
        del start

        # --- the window -----------------------------------------------------
        synchronize(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        sim.run()
        synchronize(device)
        window_s = time.perf_counter() - t0
        att1 = int(sim.counters()[0].sum())
        end = sim.mc
        watch.update(end)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        metrics = {
            "sweeps_per_s": (att1 - att0) / n / window_s,
            "msd_per_s": float(watch.per_chain().mean()) / window_s,
            "setup_s": setup_s,
        }
        att_chain = end.attempted.sum(dim=-1) - att0_chain
        skips = getattr(end, "skipped", skip0) - skip0
        finite = torch.isfinite(end.system.position).flatten(1).all(dim=1) & torch.isfinite(end.system.energy)
        blocks = blocks_of(cfg, steps, times)
        checks_exact = {
            "counter_mismatch": counter_mismatch(att_chain, skips, steps, n),
            "species_changed": int((composition(end.system.species, S) != comp0).any(dim=-1).sum()),
            "nonfinite": int((~finite).sum()),
        }
        failed = int(skips.sum()) + checks_exact["nonfinite"] * blocks
        box = end.system.box[sample].clone()
        chunk_s = np.diff(watch.times)
        acc = sim.counters()
        log(f"window: {steps} sweeps in {window_s:.3f} s (probe pace {p.pace:.3f} sweeps/s), "
            f"{len(chunk_s)} host returns; seconds between them: median {statistics.median(chunk_s):.4f}, "
            f"p90 {float(np.quantile(chunk_s, 0.9)):.4f}; acceptance {float(acc[1].sum()) / max(1, float(acc[0].sum())):.4f}; "
            f"skipped chain-blocks {int(skips.sum())} of {B * blocks} ({int(skips.sum()) / (B * blocks):.3e}); "
            f"seconds of each stretch: {' '.join(f'{t:.3f}' for t in chunk_s)}")

        result = {"attempted": B * blocks, "failed": failed}
        if traced:
            metrics, result["device"], result["breakdown"] = traced_slice(
                cell, end.system, p.table, p.pool, p.seeds["slice"], f"{p.tmp}/slice", device
            )
        snaps = watch.snaps
        del sim, end, watch, p.start
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # --- the check, after the window ----------------------------------
        t0 = time.perf_counter()
        checks = judge(cfg, trf, snaps, box, p.seeds["reference"])
        log(f"reference check: {time.perf_counter() - t0:.3f} s over {k} chains, {len(snaps)} snapshots")
        checks.update({name: (v, 0) for name, v in checks_exact.items()})
        result.update(
            correct=all(v <= lim for v, lim in checks.values()),
            metrics=metrics, memory_peak=memory_peak, checks=checks, steps=steps,
        )
        return result
    finally:
        shutil.rmtree(p.tmp, ignore_errors=True)


def judge(cfg: dict, trf: dict, snaps: list, box, seed: int) -> dict:
    """The numbers compared against the plain reference, each with its
    limit from the traffic file, over the sampled chains' snapshots (at
    most MAX_STRETCHES stretches for the drift: consecutive ones merged,
    evenly): the ledger's drift, the largest acceptance gap of the pool's
    displacements, the frozen excess and, where the pool has moves that
    exchange species (swaps), the largest acceptance gap of those; each
    kind's gaps are held apart, so that a fault of the rarer, noisier
    swaps is not judged by the displacements' limit nor the reverse. A pool
    of several moves also holds the share of attempts each move got over
    the window against its probability (`move_share_z`)."""
    limits = trf["limits"]
    first, last, origin, steps = acceptance_span(trf, snaps)
    gaps, prog, ref = acceptance_gap(cfg, trf, first, last, origin, steps, box, seed)
    made, where = moves_between(first, last), "start" if origin is first else "end"
    for m, (mv, a, b) in enumerate(zip(trf["pool"], prog, ref)):
        log(f"acceptance of the sampled chains, move {m} ({mv['move']}): program {a:.6f} over {made} moves "
            f"of each chain from the window's start, reference {b:.6f} over {steps} steps from its {where} state")
    if len(snaps) > MAX_STRETCHES + 1:
        keep = np.unique(np.linspace(0, len(snaps) - 1, MAX_STRETCHES + 1).round().astype(int))
        snaps = [snaps[i] for i in keep]
    moving = displacements(trf)
    exchanging = [m for m in range(len(trf["pool"])) if m not in moving]
    checks = {
        "ledger_drift": (ledger_drift(cfg["potential"], snaps, box), float(limits["ledger_drift"])),
        "acceptance_gap": (largest(gaps, moving), float(limits["acceptance_gap"])),
        "frozen_excess": (frozen_excess(snaps[0], snaps[-1], int(cfg["system"]["n"]), moving),
                          float(limits["frozen_excess"])),
    }
    if exchanging:
        checks["species_acceptance_gap"] = (largest(gaps, exchanging), float(limits["species_acceptance_gap"]))
    if len(trf["pool"]) > 1:
        checks["move_share_z"] = (share_z(trf, snaps[0], snaps[-1]), float(limits["move_share_z"]))
    return checks


def traced_slice(cell, system, table, pool, seed, path, device):
    """The per-layer metrics from a profiled slice on the window's end
    state: a Simulation of the traffic's `trace.steps` (with its own
    `sweepstep` where given), run once to warm and once under the profiler."""
    cfg, trf = cell.config, cell.traffic
    tcfg = trf["trace"]
    sl = simulation(system, table, pool, cfg, seed, tcfg["steps"], path, sweepstep=tcfg.get("sweepstep"))
    sl.run()
    k = min(system.n_chains, int(tcfg["count_chains"]))
    start = SimpleNamespace(
        position=sl.mc.system.position[:k].clone(), species=sl.mc.system.species[:k].clone(),
        box=sl.mc.system.box[:k].clone(),
    )
    a0 = sl.counters()[0]
    tr = trace.profile(sl.run)
    attempted = sl.counters()[0] - a0
    n, B = int(cfg["system"]["n"]), system.n_chains
    run = SimpleNamespace(
        trace=tr, attempted_by_move=attempted.tolist(), start=start, config=cfg, traffic=trf,
        dtype=PRECISIONS[trf["precision"]][0], chains=B, n=n,
        # sweeps of the whole batch (N attempted moves of every chain), as
        # sweeps_per_s counts them, and steps of every chain (one move each)
        sweeps=float(attempted.sum()) / (n * B), moves_per_chain=float(attempted.sum()) / B,
    )
    metrics = {}
    for m in cell.per_layer:
        value = spec.reader(cell, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = value
    device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    log(f"slice: {int(tcfg['steps'])} engine steps, {run.sweeps:.4f} sweeps of the batch, {len(tr.device_ops)} device ops, "
        f"{tr.stream_syncs} stream syncs, busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s")
    return metrics, device_info, breakdown

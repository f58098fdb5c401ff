"""The control of the benchmark's check, the planted faults, and the
readings the limits are set from: runs of one cell in one process, on
several seeds. Each run makes the cell's set-up (the program's burn-in and
probe), then its window, and prints one JSON line with the numbers the
check compares:

- `program`: the program as the traffic states it (the lower readings);
- `float32-ledger`: the control where the program has it, its own float32
  ledger in place of the float64 ledger of mixed precision;
- `reference-bf16`: the control where that path does not separate, the
  plain reference sampler put in the program's place for the traffic's
  `control_steps` steps, its energy changes in bfloat16
  (reference/sampler.py, or the traffic's own `reference_sampler` for a
  pool with swaps; its drift alone);
- `sigma-2x`, `temperature-2x`: the program with its displacements twice
  as wide, or at twice the configuration's temperature (faults of the
  proposal and of the Metropolis test);
- `swap-no-hastings`: the program with the Hastings term of its
  EnergyBias swaps dropped (log q_rev taken equal to log q_fwd), a fault
  of the swap's acceptance;
- `swaps-never`, `swaps-half`: the program with every draw of a move
  other than the pool's first (the swaps, in the swap cell's pool) turned
  into the first, at every step or at every other step: faults of the
  move's choice.

The benchmark's own runs never run this.

    python3 perfbench/control.py --workload <cell> --seconds <s> --mode float32-ledger --seeds 1 2 3
"""

import json
import os
import shutil
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = ("program", "float32-ledger", "reference-bf16", "sigma-2x", "temperature-2x", "swap-no-hastings",
         "swaps-never", "swaps-half")
PLANTS = {"program": {}, "sigma-2x": {"sigma_scale": 2.0}, "temperature-2x": {"temperature_scale": 2.0},
          "swap-no-hastings": {}, "swaps-never": {}, "swaps-half": {}}


def drop_hastings():
    """Plant `swap-no-hastings` in the program for the rest of the process:
    every EnergyBias proposal's log q_rev is replaced by its log q_fwd
    (where it is finite: an empty population still rejects)."""
    import torch

    from particlesmc_tpu_torch.moves import kernel

    real = kernel._propose_swap_energy_bias

    def propose(*args, **kw):
        p = real(*args, **kw)
        return p._replace(log_q_rev=torch.where(torch.isinf(p.log_q_rev), p.log_q_rev, p.log_q_fwd))

    kernel._propose_swap_energy_bias = propose


def skew_choice(every: int):
    """Plant `swaps-never` (every 1) or `swaps-half` (every 2) in the
    program for the rest of the process: at every `every`-th step of a
    sweep's draws, a draw of any move but the pool's first becomes the
    first."""
    import torch

    from particlesmc_tpu_torch.moves import kernel

    real = kernel._Kernel.draw_sweep

    def draw_sweep(self, mc, steps):
        out = real(self, mc, steps)
        move = out["move"]
        hit = (move > 0) & (torch.arange(move.shape[1], device=move.device) % every == 0)
        out["move"] = torch.where(hit, torch.zeros_like(move), move)
        return out

    kernel._Kernel.draw_sweep = draw_sweep


def reference_window(cell, seed, seconds, device):
    """The cell's set-up, then the reference sampler in the window's place;
    returns the drift the check compares."""
    import numpy as np
    import torch

    from perfbench import cell as CELL
    from perfbench.reference import swap_sampler
    from perfbench.reference.sampler import metropolis

    trf, cfg = cell.traffic, cell.config
    p = CELL.prepare(cell, seed, seconds, device)
    try:
        B = p.start.n_chains
        k = min(B, int(trf["reference_chains"]))
        sample = torch.as_tensor(np.sort(np.random.default_rng(p.seeds["sample"]).choice(B, k, replace=False)), device=device)
        st = p.start
        g = torch.Generator(device=device)
        g.manual_seed(p.seeds["window"])
        temp = torch.full((k,), float(cfg["system"]["temperature"]), dtype=torch.float64, device=device)
        x0, sp0 = st.position[sample], st.species[sample]
        if trf["reference_sampler"] == "sampler":
            sigma = float(trf["pool"][0]["args"]["sigma"])
            x, l0, l1, att, _ = metropolis(x0, sp0, st.box[sample], temp, cfg["potential"], sigma, trf["control_steps"], g)
            sp, att = sp0, att[:, None]
        else:
            x, sp, l0, l1, att, _ = swap_sampler.metropolis(x0, sp0, st.box[sample], temp, cfg["potential"], trf["pool"],
                                                            trf["control_steps"], g, compute=torch.bfloat16)
        snaps = [dict(position=x0.cpu(), species=sp0.cpu(), ledger=l0.cpu(), attempted=torch.zeros_like(att).cpu()),
                 dict(position=x.cpu(), species=sp.cpu(), ledger=l1.cpu(), attempted=att.cpu())]
        drift = CELL.ledger_drift(cfg["potential"], snaps, st.box[sample])
        return {"ledger_drift": drift}, int(trf["control_steps"])
    finally:
        shutil.rmtree(p.tmp, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench import cell as CELL
    from perfbench import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 1
    c = spec.cell(args.workload)
    if args.mode == "swap-no-hastings":
        drop_hastings()
    elif args.mode in ("swaps-never", "swaps-half"):
        skew_choice(1 if args.mode == "swaps-never" else 2)
    for seed in args.seeds:
        if args.mode == "reference-bf16":
            checks, steps = reference_window(c, seed, args.seconds, device)
            metrics = {}
        else:
            plant = {"ledger": torch.float32} if args.mode == "float32-ledger" else PLANTS[args.mode]
            out = CELL.run_cell(c, seed, args.seconds, False, device, time.perf_counter(), plant=plant)
            checks, steps, metrics = {k: v for k, (v, _) in out["checks"].items()}, out["steps"], out["metrics"]
        limits = c.traffic["limits"]
        print(json.dumps({
            "workload": c.name, "mode": args.mode, "seed": seed, "steps": steps,
            "fails": sorted(k for k, v in checks.items() if v > float(limits.get(k, 0))),
            "checks": checks, "metrics": metrics,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

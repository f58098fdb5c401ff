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
  (reference/sampler.py; its drift alone);
- `sigma-2x`, `temperature-2x`: the program with its displacements twice
  as wide, or at twice the configuration's temperature (faults of the
  proposal and of the Metropolis test).

The benchmark's own runs never run this.

    python3 perfbench/control.py --workload <cell> --seconds <s> --mode float32-ledger --seeds 1 2 3
"""

import json
import os
import shutil
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = ("program", "float32-ledger", "reference-bf16", "sigma-2x", "temperature-2x")
PLANTS = {"program": {}, "sigma-2x": {"sigma_scale": 2.0}, "temperature-2x": {"temperature_scale": 2.0}}


def reference_window(cell, seed, seconds, device):
    """The cell's set-up, then the reference sampler in the window's place;
    returns the drift the check compares."""
    import numpy as np
    import torch

    from perfbench import cell as CELL
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
        sigma = float(trf["pool"][0]["args"]["sigma"])
        temp = torch.full((k,), float(cfg["system"]["temperature"]), dtype=torch.float64, device=device)
        x, l0, l1, att, _ = metropolis(st.position[sample], st.species[sample], st.box[sample], temp,
                                       cfg["potential"], sigma, trf["control_steps"], g)
        snaps = [dict(position=st.position[sample].cpu(), ledger=l0.cpu(), attempted=torch.zeros_like(att).cpu()),
                 dict(position=x.cpu(), ledger=l1.cpu(), attempted=att.cpu())]
        drift = CELL.ledger_drift(cfg["potential"], snaps, st.species[sample], st.box[sample])
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

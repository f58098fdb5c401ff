"""TOML-driven command-line front end (counterpart of particlesmc_tpu/cli.py).

`python -m particlesmc_tpu_torch params.toml [--device cpu]` reads the same
schema as the reference package:

[system]      config / temperature (a scalar, or a ladder) / density / model
              (or [model."i-j"] blocks) / list_type / list_parameters
              (cap, force_cells; checkerboard: inner, rebin_every, trim =
              "auto" / a lane count for the candidate compaction)
[simulation]  steps / burn / seed / parallel_moves (false: the sequential
              kernel) / sweepstep / output_path / nsim / precision (f64
              default, f32, mixed = f32 state + f64 ledger) /
              spatial_devices (one system's grid in slabs over that many
              cards) / profile_dir (a torch.profiler trace of the run)
[[simulation.move]]    action / policy / probability / parameters
[[simulation.output]]  algorithm / scheduler_params {linear_interval,
                       log_base} / callbacks / dependencies / fmt;
                       AdaptiveSigma: move / target / kappa / sigma_max;
                       StoreCheckpoints: history

`--resume checkpoint.npz` continues a run from a StoreCheckpoints file
(engine/simulation.py). PGMC (PolicyGradientEstimator) is library-only, as
in the JAX package. The run is on the card unless `--device` names another
device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tomllib
from typing import Any, Dict

import torch

from .engine.schedule import build_schedule
from .moves import base as MB
from .runtime import resolve_device


def _build_pool(move_cfgs):
    pool = []
    for mv in move_cfgs:
        action = mv["action"]
        policy = mv.get("policy")
        prob = float(mv["probability"])
        params = mv.get("parameters", {})
        if action == "Displacement":
            if "sigma" not in params:
                raise ValueError("Missing parameter 'sigma' for action: Displacement")
            if policy == "SimpleGaussian":
                pool.append(MB.displacement(params["sigma"], prob))
            elif policy == "SmartGaussian":
                pool.append(MB.displacement_smart(params["sigma"], prob))
            else:
                raise ValueError(f"Unsupported policy: {policy} for action: {action}")
        elif action == "DiscreteSwap":
            sp = params.get("species")
            if not sp or len(sp) != 2:
                raise ValueError("'species' for action DiscreteSwap must be two ints")
            s1, s2 = int(sp[0]) - 1, int(sp[1]) - 1  # file species are 1-based
            if policy == "DoubleUniform":
                pool.append(MB.discrete_swap(s1, s2, prob))
            elif policy == "EnergyBias":
                pool.append(
                    MB.discrete_swap(
                        s1, s2, prob, policy="energy_bias",
                        theta1=params.get("theta1", 0.0), theta2=params.get("theta2", 0.0),
                    )
                )
            else:
                raise ValueError(f"Unsupported policy: {policy} for action: {action}")
        elif action == "MoleculeFlip":
            if policy != "DoubleUniform":
                raise ValueError(f"Unsupported policy: {policy} for action: {action}")
            pool.append(MB.molecule_flip(prob))
        else:
            raise ValueError(f"Unsupported action: {action}")
    return tuple(pool)


def _build_outputs(output_cfgs, steps, burn):
    algos = []
    for out in output_cfgs:
        alg = out["algorithm"]
        sp = out.get("scheduler_params", {})
        interval = sp.get("linear_interval", steps)
        if "log_base" in sp:
            block = build_schedule(interval, 0, float(sp["log_base"]))
            sched = build_schedule(steps, burn, list(block))
        else:
            sched = build_schedule(steps, burn, int(interval))
        entry: Dict[str, Any] = {"algorithm": alg, "scheduler": sched}
        if alg == "StoreCallbacks":
            entry["callbacks"] = tuple(out.get("callbacks", []))
        elif alg == "StoreAcceptance":
            entry["dependencies"] = tuple(out.get("dependencies", ["Metropolis"]))
        elif alg in ("StoreTrajectories", "StoreLastFrames"):
            entry["fmt"] = out.get("fmt", "XYZ")
        elif alg == "StoreCheckpoints":
            entry["history"] = bool(out.get("history", False))
        elif alg in ("PolicyGradientEstimator", "PolicyGradientUpdate"):
            raise ValueError(f"{alg} runs through the library only (engine/pgmc.py), as in the JAX package")
        elif alg == "AdaptiveSigma":
            # schedule it over the burn-in window: it freezes after its last event
            if "move" in out:
                entry["move"] = int(out["move"]) - 1  # TOML move ids are 1-based
            for k in ("target", "kappa", "sigma_max"):
                if k in out:
                    entry[k] = float(out[k])
        # Simulation checks the names: ValueError for unknown ones
        algos.append(entry)
    return algos


PRECISIONS = {
    # name: (state dtype, energy ledger dtype or None)
    "f64": (torch.float64, None),
    "float64": (torch.float64, None),
    "double": (torch.float64, None),
    # f32 state + f64 ledger: long runs book millions of O(1) energy changes
    # into an O(1e4) accumulator, which an f32 ledger would let drift
    "mixed": (torch.float32, torch.float64),
    "f32x64": (torch.float32, torch.float64),
}


def run_params(params: Dict[str, Any], device=None, resume=None):
    """Assemble and run a Simulation from a parsed TOML dict; returns it.
    `resume` names a StoreCheckpoints file to continue from."""
    from .engine.simulation import Simulation
    from .io.loader import load_chains

    device = resolve_device(device)
    system = params["system"]
    sim_cfg = params["simulation"]

    precision = str(sim_cfg.get("precision", system.get("precision", "f64")))
    dtype, energy_dtype = PRECISIONS.get(precision, (torch.float32, None))

    model = system.get("model", params.get("model"))
    if model is None:
        raise ValueError('model must be given in [system] or as [model."i-j"] blocks')

    args = {
        "temperature": system.get("temperature"),
        "density": system.get("density"),
        "model": model,
        "list_type": system.get("list_type", "LinkedList"),
        "list_parameters": system.get("list_parameters"),
        "nsim": sim_cfg.get("nsim"),
    }
    chains = load_chains(
        system["config"], args=args, verbose=bool(sim_cfg.get("verbose", False)),
        dtype=dtype, energy_dtype=energy_dtype, device=device,
    )

    steps = int(sim_cfg["steps"])
    burn = int(sim_cfg.get("burn", 0))
    pool = _build_pool(sim_cfg.get("move", []))
    algorithms = [
        {
            "algorithm": "Metropolis",
            "pool": pool,
            "seed": int(sim_cfg.get("seed", 0)),
            "sweepstep": int(sim_cfg.get("sweepstep", chains.n_particles)),
            "parallel_moves": bool(sim_cfg.get("parallel_moves", False)),
            "spatial_devices": int(sim_cfg.get("spatial_devices", 0)),
        }
    ] + _build_outputs(sim_cfg.get("output", []), steps, burn)

    sim = Simulation(
        chains,
        algorithms,
        steps,
        path=sim_cfg.get("output_path", "./"),
        verbose=bool(sim_cfg.get("verbose", True)),
        resume=resume,
        profile_dir=sim_cfg.get("profile_dir"),
    )
    sim.run()
    return sim


def run_file(path: str, device=None, resume=None):
    """Run the simulation a params file describes; returns the Simulation.

    A relative `[system] config` that does not exist under the working
    directory resolves against the params file's own directory."""
    with open(path, "rb") as f:
        params = tomllib.load(f)
    cfg = params.get("system", {}).get("config")
    if cfg and not os.path.isabs(cfg) and not os.path.exists(cfg):
        beside = os.path.join(os.path.dirname(os.path.abspath(path)), cfg)
        if os.path.exists(beside):
            params["system"]["config"] = beside
    return run_params(params, device=device, resume=resume)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m particlesmc_tpu_torch",
        description="Run a particlesmc TOML simulation with the PyTorch/CUDA port.",
    )
    parser.add_argument("params", help="params.toml")
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; 'cpu' runs the plain versions)",
    )
    parser.add_argument(
        "--resume", default=None, metavar="CHECKPOINT",
        help="continue from a StoreCheckpoints file (its outputs are appended to)",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    if not os.path.isfile(args.params):
        print(f"Parameter file '{args.params}' does not exist in the current path.")
        return 1
    if args.resume is not None and not os.path.isfile(args.resume):
        print(f"Checkpoint file '{args.resume}' does not exist in the current path.")
        return 1
    run_file(args.params, device=args.device, resume=args.resume)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

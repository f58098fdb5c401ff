"""Benchmark of particlesmc_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on and needs as many CUDA cards as the
cell asks for; without them it exits non-zero and prints no result. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device and, with --trace 1, breakdown; the numbers
compared for `correct` come last, under `checks`, each beside its limit,
and again as the last lines of standard error.
"""

import time

T_START = time.perf_counter()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not this folder: perfbench is a package

# modules that must not be loaded: the JAX package and JAX itself, by the
# whole top-level name (particlesmc_tpu_torch begins with particlesmc_tpu)
FORBIDDEN = {"jax", "jaxlib", "flax", "particlesmc_tpu"}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import cell as CELL
    from perfbench import spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {c.name} needs {c.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    limit = power_limit()
    out = CELL.run_cell(c, args.seed, args.seconds, bool(args.trace), device, T_START)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    entries = c.per_layer if args.trace else c.end_to_end
    metrics = {
        m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
        for m in entries if m["name"] in out["metrics"]
    }
    device_info = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": c.chips,
        "memory_peak_bytes": int(out["memory_peak"]), "power_limit": limit,
    }
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info.update(out["device"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

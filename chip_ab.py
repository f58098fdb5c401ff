"""The main path's library phase of two checkouts on one card, in the order
A, B, B, A (repeated ROUNDS times, default 1), each run in a process of its
own.

    python3 chip_ab.py A_DIR B_DIR [ROUNDS]

Each run imports that checkout's chip_smoke.py and particlesmc_tpu_torch,
builds its kernel and calls its `phase_library` (N = 10,000 KA-LJ, 256
chains, mixed precision: one warm-up block, three timed blocks and one
profiled block). Prints each run's library line tagged with its checkout
and a digest of its final state (positions, species, ledgers and counters),
then one summary line of block times, sweeps/s, device launches and stream
synchronisations per traced block and the digests for each checkout, and
whether every run ended in the same state. Needs CUDA; exits non-zero if a
run fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def child(tree: str) -> int:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    import particlesmc_tpu_torch

    for mod in (chip_smoke, particlesmc_tpu_torch):
        assert os.path.abspath(mod.__file__).startswith(tree + os.sep), mod.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cb, _ = chip_smoke.phase_library(torch.device("cuda"))
    h = hashlib.sha256()
    for t in (cb.system.position, cb.system.species, cb.system.energy, cb.attempted, cb.accepted):
        h.update(t.cpu().numpy().tobytes())
    print(json.dumps({"digest": h.hexdigest(), "accepted": int(cb.accepted.sum())}), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(os.path.abspath(argv[1]))
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in argv[:2]]
    rounds = int(argv[2]) if len(argv) == 3 else 1
    runs = {t: [] for t in trees}
    for tree in (trees[0], trees[1], trees[1], trees[0]) * rounds:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            cwd=tree, capture_output=True, text=True, timeout=600,
        )
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode or 1
        line = next(json.loads(s) for s in out.stdout.splitlines() if s.startswith('{"phase": "library"'))
        line.update(next(json.loads(s) for s in out.stdout.splitlines() if s.startswith('{"digest"')))
        runs[tree].append(line)
        print(json.dumps({"tree": tree, **line}), flush=True)
    print(json.dumps({"summary": {
        t: {
            "block_ms": [r["block_ms"] for r in rs],
            "sweeps_per_s": [r["sweeps_per_s"] for r in rs],
            "launches_per_block": [r["launches_per_block"] for r in rs],
            "device_launches_per_traced_block": [r["profiled_block"]["device_launches"] for r in rs],
            "device_busy_ms": [r["profiled_block"]["device_busy_ms"] for r in rs],
            "stream_syncs_per_traced_block": [r["profiled_block"]["stream_syncs"] for r in rs],
            "digest": [r["digest"] for r in rs],
        } for t, rs in runs.items()
    }, "same_state": len({r["digest"] for rs in runs.values() for r in rs}) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

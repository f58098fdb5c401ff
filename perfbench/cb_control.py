"""control.py's readings for a checkerboard cell whose pool mixes moves:
the move-choice faults `swaps-never` and `swaps-half` planted in the
checkerboard's static slot schedule, where control.py plants them in the
sequential kernel's per-step draws (which the checkerboard never makes).
Every other mode runs as control.py runs it. The benchmark's own runs
never run this.

    python3 perfbench/cb_control.py --workload ljmix-n4096.cb-swap-b8 --seconds 51 --mode swaps-half --seeds 1 2 3
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import control  # noqa: E402


def skew_schedule(every: int):
    """Plant `swaps-never` (every 1) or `swaps-half` (every 2) in the
    program for the rest of the process: of the slots that the checkerboard's
    schedule gives to a move other than the pool's first, every `every`-th
    in slot order goes to the first move instead."""
    from particlesmc_tpu_torch.moves import checkerboard

    real = checkerboard._slot_schedule

    def slot_schedule(pool, C, inner):
        sched = real(pool, C, inner)
        flat = sched.reshape(-1).copy()
        other = [k for k, m in enumerate(flat) if m > 0]
        flat[other[::every]] = 0
        return flat.reshape(sched.shape)

    checkerboard._slot_schedule = slot_schedule


def main(argv=None) -> int:
    control.skew_choice = skew_schedule
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""The hand kernel's share of its roofline, in percent: the least time the
card could take for the slice's Gaussian displacement sub-moves (the larger
of their operations over the peak of the positions' type and their bytes
over the HBM rate, perfbench/count.py, counted from the slice's start
state) for as many sub-moves as the program's counters say it attempted,
over the device time of the slice's disp_substep_kernel* launches. The
counters are those sweeps_per_s reads and the check holds (every chain the
same whole number per step, and the acceptance they imply against the plain
reference's). Nothing to read where no such launch ran."""

from perfbench import count

LAYER = "hand kernel"
MOVES = "sweeps_per_s"
KERNEL = "disp_substep_kernel"


def read(run):
    kernel_s = run.trace.device_seconds(lambda name: KERNEL in name)
    if kernel_s <= 0.0:
        return None
    inner = int(run.config["sampler"]["list_parameters"]["inner"])
    least = 0.0
    for m, move in enumerate(run.traffic["pool"]):
        if move["move"] != "displacement" or run.attempted_by_move[m] == 0:
            continue
        ops, nbytes, _ = count.submove_cost(
            run.start.position, run.start.species, run.start.box, run.config["potential"],
            float(move["args"]["sigma"]), inner, run.dtype,
        )
        least += count.least_seconds(ops * run.attempted_by_move[m], nbytes * run.attempted_by_move[m], run.dtype)[0]
    return 100.0 * least / kernel_s

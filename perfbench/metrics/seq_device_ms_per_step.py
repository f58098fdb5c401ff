"""Device milliseconds per step of the sequential kernel (every chain
makes one attempted move, read from the program's counters), in the
profiled slice."""

LAYER = "sequential step"
MOVES = "sweeps_per_s"


def read(run):
    return 1e3 * run.trace.busy_s / run.moves_per_chain

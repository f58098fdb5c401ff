"""Device operations the host issued per sweep of the whole batch (N
attempted moves of every chain, read from the program's counters, as
sweeps_per_s counts them), in the profiled slice."""

LAYER = "engine and host issue"
MOVES = "sweeps_per_s"


def read(run):
    return len(run.trace.device_ops) / run.sweeps

"""Share of the profiled slice's wall time in which no operation ran on
the device, in percent."""

LAYER = "device (H100)"
MOVES = "sweeps_per_s"


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

"""Host milliseconds per sweep of the whole batch (N attempted moves of
every chain, as sweeps_per_s counts them) inside the profiled slice's
`cb.submove.<kind>` ranges: the checkerboard's sub-moves that are not the
hand kernel's (swaps, flips, smart and molecular displacements), issued in
plain PyTorch. The profiler slows the host's issue, so this reads above the
untraced run's share. Nothing to read where the slice holds no such range."""

LAYER = "checkerboard glue and sub-moves"
MOVES = "sweeps_per_s"
RANGE = "cb.submove."


def read(run):
    spans = [e - s for name, s, e in run.trace.host_ops if name.startswith(RANGE)]
    if not spans:
        return None
    return sum(spans) / 1e3 / run.sweeps

"""Device milliseconds per sweep of the whole batch (N attempted moves of
every chain, as sweeps_per_s counts them) that are not the hand
kernel's (disp_substep_kernel*): the checkerboard's rebin, extract,
write-back, draws, counters and any plain-PyTorch sub-move. Nothing to
read where no hand-kernel operation ran."""

LAYER = "checkerboard glue and sub-moves"
MOVES = "sweeps_per_s"
KERNEL = "disp_substep_kernel"


def read(run):
    tr = run.trace
    if tr.count(lambda name: KERNEL in name) == 0:
        return None
    return 1e3 * (tr.busy_s - tr.device_seconds(lambda name: KERNEL in name)) / run.sweeps

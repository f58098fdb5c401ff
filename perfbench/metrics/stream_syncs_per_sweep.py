"""The host's cudaStreamSynchronize calls per sweep of the whole batch (N
attempted moves of every chain, as sweeps_per_s counts them), in the
profiled slice."""

LAYER = "engine and host issue"
MOVES = "sweeps_per_s"


def read(run):
    return run.trace.stream_syncs / run.sweeps

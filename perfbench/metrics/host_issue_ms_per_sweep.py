"""Host milliseconds per sweep of the whole batch (N attempted moves of
every chain, as sweeps_per_s counts them) that the engine spends issuing
work in the profiled slice: the summed duration of the program's
`engine.chunk` ranges less the runtime calls inside them that waited for
the device (every cudaStreamSynchronize, cudaDeviceSynchronize and
cudaEventSynchronize; each cudaMemcpyAsync or cudaMemcpy during which its
host-device copy ran: perfbench/phases.py). The profiler slows the host's
issue, so this reads above the untraced run's issue. Nothing to read where
the program has no such range."""

from perfbench import phases

LAYER = "engine and host issue"
MOVES = "sweeps_per_s"


def read(run):
    got = phases.split(run.trace)
    return None if got is None else got[0] / 1e3 / run.sweeps

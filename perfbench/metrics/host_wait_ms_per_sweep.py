"""Host milliseconds per sweep of the whole batch (N attempted moves of
every chain, as sweeps_per_s counts them) that the engine spends waiting
for the device in the profiled slice: the runtime calls inside the
program's `engine.chunk` ranges that waited for the device (every
cudaStreamSynchronize, cudaDeviceSynchronize and cudaEventSynchronize;
each cudaMemcpyAsync or cudaMemcpy during which its host-device copy ran:
perfbench/phases.py). The profiler slows the host's issue, so the device
drains sooner than in an untraced run and this reads below its wait.
Nothing to read where the program has no such range."""

from perfbench import phases

LAYER = "engine and host issue"
MOVES = "sweeps_per_s"


def read(run):
    got = phases.split(run.trace)
    return None if got is None else got[1] / 1e3 / run.sweeps

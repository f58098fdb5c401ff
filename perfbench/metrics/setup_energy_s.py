"""Seconds of the run's set-up spent in the program's start energy
(core/energy.py::initialize_energy, the dense O(B N^2) pass): the host
seconds of its `setup.initialize_energy` phase in the program's
tracing.totals(), which ends after the energy's finiteness check has waited
for the device. Read in the traced run, whose set-up is the untraced run's.
Nothing to read where the program has no such phase."""

LAYER = "set-up (core/energy.py)"
MOVES = "setup_s"
PHASE = "setup.initialize_energy"


def read(run):
    try:
        from particlesmc_tpu_torch import tracing
    except ImportError:  # a program without the tracing module
        return None
    entry = tracing.totals().get(PHASE)
    return None if entry is None else entry[1]

"""particlesmc-tpu-torch: the PyTorch/CUDA port of `particlesmc_tpu`.

NVT Metropolis Monte Carlo of particle systems, run on an NVIDIA GPU. The
package mirrors the JAX package's layout (models/, core/, moves/, engine/,
io/, cli.py) so each module has a counterpart there; the JAX package stays
the reference that the port is tested against. It covers the checkerboard
hyper-sweep backend, batched over chains, with every move pool of the JAX
backend on atomic and molecular systems; the Gaussian displacement sub-moves
of an atomic pool run in a hand-written CUDA kernel (moves/cb_cuda.py,
csrc/cb_disp_substep.cu).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without CUDA and without an explicit device they raise.
"""

from .core.energy import initialize_energy, total_energy_dense
from .core.state import SystemState, make_system
from .models.tables import (
    BHHP,
    JBB,
    KobAndersen,
    MODEL_REGISTRY,
    PairTable,
    Trimer,
    build_pair_table,
    general_kg,
    lennard_jones,
    resolve_model,
    smooth_lennard_jones,
    soft_spheres,
)

__version__ = "0.1.0"

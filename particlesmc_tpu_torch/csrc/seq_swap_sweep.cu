// Sequential sweep with species swaps: the swap instantiations of the
// sequential sweep kernel (seq_sweep.cuh, which holds the kernel, its layout,
// its design notes and the entry points), for pools of Gaussian
// displacements, DoubleUniform swaps and EnergyBias swaps, with the dense
// energy change, on atomic systems; with the chains' per-particle energies
// kept on chip when the pool has an EnergyBias swap. The Python wrapper is
// particlesmc_tpu_torch/moves/seq_cuda.py::sweep.

#define SEQ_SWEEP_SWAPS 1
#include "seq_sweep.cuh"

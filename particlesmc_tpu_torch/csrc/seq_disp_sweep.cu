// Sequential displacement sweep: the displacement-only instantiations of the
// sequential sweep kernel (seq_sweep.cuh, which holds the kernel, its layout,
// its design notes and the entry points), for pools whose every move is a
// Gaussian displacement, with the dense energy change, on atomic systems. The
// Python wrapper is particlesmc_tpu_torch/moves/seq_cuda.py::sweep.

#define SEQ_SWEEP_SWAPS 0
#include "seq_sweep.cuh"

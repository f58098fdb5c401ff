// Device code shared by the hand kernels cb_disp_substep.cu and
// seq_disp_sweep.cu: the packed pair table's fields, the potential variants,
// the parameters of one species pair, models/potentials.py::pair_potential
// for one pair within its cutoff, and a warp sum that leaves the same bits in
// every lane. Each kernel includes it once, into its own anonymous namespace.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kFields = 9;
constexpr unsigned kFull = 0xffffffffu;
enum Field { F_KIND, F_EPS4, F_SIGMA2, F_IPL_N, F_RCUT2, F_SHIFT, F_C0, F_C2S2, F_C4S4 };

// errors of a launcher itself; CUDA's own codes are positive
constexpr int kErrUnsupported = -1;
constexpr int kErrSharedMemory = -2;

// Potential variants, chosen by the kinds present in the table
// (models/tables.py::kinds_present): one kind only, or any mix.
enum Variant { V_GENERIC = 0, V_INVERSE_POWER = 1, V_LENNARD_JONES = 2, V_SMOOTH_LJ = 3 };

// How the potential takes sigma2 / r2: as sigma2 times a correctly rounded
// reciprocal (the checkerboard kernel, as its plain version in cb_cuda.py),
// or as the quotient (the sequential sweep, as the plain step).
enum Quotient { Q_RECIPROCAL, Q_DIVIDE };

__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// The fields of one species pair that variant V reads.
template <typename T>
struct PairParams {
  T eps4, sigma2, shift, c0, c2s2, c4s4;
  int ipl_n, kind;
};

// The mover's row of the table, hoisted per move: field f of the pair
// (mover's species, species s) is row.f[s].
template <typename T>
struct Row {
  const T *eps4, *sigma2, *rcut2, *shift, *c0, *c2s2, *c4s4;
  const int *kind, *ipl_n;
};

template <typename T, int V>
__device__ __forceinline__ PairParams<T> load_pair(const Row<T>& row, int s) {
  PairParams<T> q{};
  q.eps4 = row.eps4[s];
  q.sigma2 = row.sigma2[s];
  if (V != V_SMOOTH_LJ) q.shift = row.shift[s];
  if (V == V_GENERIC || V == V_SMOOTH_LJ) {
    q.c0 = row.c0[s];
    q.c2s2 = row.c2s2[s];
    q.c4s4 = row.c4s4[s];
  }
  if (V == V_GENERIC || V == V_INVERSE_POWER) q.ipl_n = row.ipl_n[s];
  if (V == V_GENERIC) q.kind = row.kind[s];
  return q;
}

// models/potentials.py::pair_potential for one pair within its cutoff, with
// sigma2 / r2 taken as Q says.
template <typename T, int V, int Q>
__device__ __forceinline__ T potential(T r2, const PairParams<T>& q) {
  const int kind = V == V_GENERIC ? q.kind : V;
  if (kind < V_INVERSE_POWER || kind > V_SMOOTH_LJ) return T(0);
  const T r2s = r2 > T(1e-12) ? r2 : T(1e-12);
  const T x = Q == Q_RECIPROCAL ? q.sigma2 * rcp(r2s) : q.sigma2 / r2s;
  if (kind == V_INVERSE_POWER) {
    // square-and-multiply, as potentials._int_pow
    T sq = sqrt(x);
    T acc = T(1);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if ((q.ipl_n >> k) & 1) acc = acc * sq;
      sq = sq * sq;
    }
    return q.eps4 * acc - q.shift;
  }
  const T x3 = x * x * x;
  const T lj = q.eps4 * (x3 * x3 - x3);
  if (kind == V_LENNARD_JONES) return lj - q.shift;
  return lj + q.eps4 * (q.c0 + r2s * (q.c2s2 + r2s * q.c4s4));
}

// Sum over the warp that leaves the same bits in every lane: at each level
// both partners add the same two operands (in swapped order, and addition
// commutes).
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

constexpr size_t round16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

}  // namespace

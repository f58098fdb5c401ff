// Sequential sweep: every step of one sweep of the sequential Metropolis
// kernel, for every chain, in one launch. Included by seq_disp_sweep.cu
// (SEQ_SWEEP_SWAPS 0: pools of Gaussian displacements) and seq_swap_sweep.cu
// (SEQ_SWEEP_SWAPS 1: pools that add DoubleUniform and EnergyBias species
// swaps); each builds its own library with the same entry points (seq_sweep,
// seq_sweep_plan, seq_error_string, at the end of this file), so a
// displacement pool never waits for the swap variants' build.
//
// Replaces no TPU kernel: the JAX package runs the sequential step as XLA ops
// (particlesmc_tpu/moves/kernel.py), and the port ran it as small PyTorch
// launches per step (~113 for displacements, ~656 with both swaps). The
// kernel takes pools of Gaussian displacements, DoubleUniform swaps and
// EnergyBias swaps, with the dense energy change, on atomic systems. The
// Python wrapper and its contract are in particlesmc_tpu_torch/moves/seq_cuda.py;
// the plain step with the same arithmetic is moves/kernel.py's.
//
// Layout (B chains, N particles, S species, M pool moves, `steps` steps):
//   pos_in     [B, N, D]      positions (unwrapped)
//   species    [B, N]         int64, 0-based
//   box        [B, D], temperature [B]
//   energy_in  [B]            the ledger (E: the position type or double)
//   table      [9, S, S]      kind, eps4, sigma2, ipl_n, rcut2, shift, c0, c2s2, c4s4
//   sigma      [B, M]         each move's sigma, per chain
//   move, pick [B, steps]     int64: the pool move and the particle of each step
//   normal     [B, steps, D]  unscaled Gaussian steps; u [B, steps] acceptance uniforms
// Outputs: pos_out [B, N, D], energy_out [B], accepts [B, steps] int64.
// The swap variants (kSwap) also take (SwapArgs):
//   moves      [M, 3]         int32: kind (MoveKind), species s1, s2 of each pool move
//   theta      [B, M, 2]      EnergyBias theta1, theta2 per chain and move (kBias)
//   r1, r2     [B, steps]     int64 ranks of a DoubleUniform swap's partners (or null)
//   gumbel     [B, steps, 2, N]  the EnergyBias picks' Gumbel noise (kBias)
//   e_scratch  [B, 2, N]      E, the per-particle energies when they do not fit in
//                             shared memory (kBias)
// and also return species_out [B, N] int64. pick and normal may be null when
// the pool has no displacement.
//
// A displacement, per chain and step: delta = sigma[move] * normal; the
// energy change dE = sum over j != i of u(r2(x_j - x_new)) - u(r2(x_j - x_old)),
// each r2 the minimum image in the chain's box; log q of the symmetric Gaussian
// enters as (-dE / T + log q) - log q, as in the plain step; accept iff dE is
// finite and log u < that. A dE with an infinite term is not finite and
// rejects, as it does in the plain step (there e_i + 0 * e_i is NaN), so an
// accepted step always books its dE. On accept particle i moves, unwrapped.
//
// A swap exchanges the species of i and j in place; dE sums the four rows of
// the plain step's energy change (i and j, old and new species) over every k
// other than i and j, where the doubly counted (i, j) term cancels; an
// infinite term of the old or new energies follows the plain step's rule (an
// infinite new energy rejects, an infinite old one alone accepts and books
// nothing). DoubleUniform: i is the r1-th particle of species s1 in id order
// and j the r2-th of s2 (a rank past the population picks N - 1, as the plain
// step's clamp does), log q = -log(n1 n2) both ways. EnergyBias: i = argmax
// over species s1 of theta1 e + gumbel[0] and j likewise over s2 (lowest id on
// ties, as torch.argmax), e the per-particle energies; log q forward from two
// masked logsumexps of theta e, reverse from the same under the swapped
// species with the energies the swap leaves. An empty population rejects.
//
// Per-particle energies (kBias): each chain's e[N] in the ledger type E, in
// shared memory with the positions where they fit, else in e_scratch. One
// dense pass at the launch's start sums each particle's pair terms, computed
// in the position type T, in E (four of a thread's particles against each j
// at once, for independent sums on one block per SM); every move then writes the energies it would
// leave into a second buffer from the pair terms its dE pass computes anyway
// (e_k + (E(new) - E(old)) for each k, the touched rows from a block sum in
// E), and an accepted move makes that buffer the current one. A step so costs
// O(N), and a pair's old term is the value its new term was before: the
// energies do not drift from a dense recompute beyond E's rounding.
//
// What bounds it: latency. A step reads a few hundred bytes and does about
// 30 N operations (a swap 60 N), but each step of a chain depends on the one
// before and ends in a reduction over the block. So the time is the length of
// that chain of dependent steps: the pair loop's instructions per thread, the
// block barriers (one per displacement, two per DoubleUniform swap, three per
// EnergyBias swap), the warp butterflies.
//
// Design: one block per chain for the whole sweep. Its positions (as [D][N])
// and species (int8) live in shared memory when they fit, else the chain's
// working copies in pos_out (and species_out) are read through L1/L2. Thread t
// owns particles t, t + blockDim, ... and is the only thread that reads or
// writes them (and their energies) in the pair loops. A reduction: every
// thread sums its part, a warp butterfly, lane 0 writes its warp's partial to
// one of two buffers (alternating), one block barrier, then every warp reduces
// the buffer with the same butterfly, so every thread holds the same bits and
// takes the same decisions: no second barrier. The owner of i writes its new
// position (and the owners of i and j their new species); every thread keeps
// the last displaced particle and position, and the last swap's particles and
// species, in registers, since a displacement reads its mover before any
// barrier of its step. A DoubleUniform rank is found from ballot masks of the
// two species, written per warp and chunk of blockDim ids, scanned by each
// warp. The next step's draws are loaded during the current one. No floating
// atomics and a fixed reduction order: a launch is bitwise reproducible.
// The potential (pair_terms.cuh) is a template on the kinds in the table (one
// variant per kind, and a generic one for any mix) and divides sigma2 by r2,
// as the plain step does. The displacement-only instantiations (kSwap false)
// keep the code they had before the swap variants existed: on sm_90a the SASS
// of the generic, Lennard-Jones and smooth-LJ variants is the same
// instruction for instruction, the inverse-power ones are scheduled apart.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_terms.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kErrThreads = -3;
// a swap variant's reduction buffer: E values and ints per warp
constexpr int kSlots = 7;
constexpr int kIntSlots = 2;
// a thread's particles summed together in the launch's dense start pass
constexpr int kStartRows = 4;

// the kinds of pool move of SwapArgs::moves
enum MoveKind { M_DISPLACEMENT = 0, M_DOUBLE_UNIFORM = 1, M_ENERGY_BIAS = 2 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Byte offsets of a block's dynamic shared memory.
struct Layout {
  size_t tab;    // [kFields][S][S] T, row maxima of rcut2 [S] T, kind and ipl_n [S][S] int
  size_t move;   // per move: sigma [M] T, sigma^2 [M] T, D log(2 pi sigma^2) / 2 [M] T
  size_t red;    // two buffers of kWarp warp sums, T
  size_t pos;    // [D][N] T (shared mode)
  size_t sp;     // [N] int8 (shared mode)
  size_t total;
  // swap variants only
  size_t kinds;  // per move: kind, s1, s2 [M][3] int; species counts [S] int
  size_t theta;  // per move: theta1, theta2 [M][2] T
  size_t redx;   // two buffers of kSlots x kWarp E, then two of kIntSlots x kWarp int
  size_t masks;  // DoubleUniform ballot masks: two species x ceil(N / threads) x warps, unsigned
  size_t e;      // per-particle energies and the next ones [2][N] E (kBias, shared mode)
};

template <typename T>
Layout make_layout(int D, int N, int S, int M, bool shared) {
  Layout l{};
  size_t o = 0;
  l.tab = o;
  o = round16(o + sizeof(T) * (kFields * S * S + S) + sizeof(int) * 2 * S * S);
  l.move = o;
  o = round16(o + sizeof(T) * 3 * M);
  l.red = o;
  o = round16(o + sizeof(T) * 2 * kWarp);
  l.pos = o;
  if (shared) o = round16(o + sizeof(T) * static_cast<size_t>(D) * N);
  l.sp = o;
  if (shared) o = round16(o + static_cast<size_t>(N));
  l.total = o;
  return l;
}

// The swap variants' regions, after the displacement layout's.
template <typename T, typename E>
Layout make_swap_layout(int D, int N, int S, int M, int threads, bool shared, bool bias) {
  Layout l = make_layout<T>(D, N, S, M, shared);
  size_t o = l.total;
  l.kinds = o;
  o = round16(o + sizeof(int) * (3 * M + S));
  l.theta = o;
  o = round16(o + sizeof(T) * 2 * M);
  l.redx = o;
  o = round16(o + 2 * (sizeof(E) * kSlots * kWarp + sizeof(int) * kIntSlots * kWarp));
  l.masks = o;
  const size_t chunks = (static_cast<size_t>(N) + threads - 1) / threads;
  o = round16(o + sizeof(unsigned) * 2 * chunks * (threads / kWarp));
  l.e = o;
  if (bias && shared) o = round16(o + sizeof(E) * 2 * static_cast<size_t>(N));
  l.total = o;
  return l;
}

struct Args {
  const void *pos_in, *species, *box, *temperature, *energy_in, *table, *sigma, *move, *pick, *normal, *u;
  int B, N, S, M, steps;
  void *pos_out, *energy_out, *accepts;
};

struct SwapArgs {
  const void *moves, *theta, *r1, *r2, *gumbel;
  void *species_out, *e_scratch;
};

// warp reductions that leave the same bits in every lane
template <typename V>
__device__ __forceinline__ V warp_allmax(V v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const V o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__device__ __forceinline__ int warp_allor(int v) { return __reduce_or_sync(kFull, v); }

// (value, id, energy) of the largest value, the lowest id among equal values
template <typename E>
__device__ __forceinline__ void warp_allargmax(E& v, int& id, E& e) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const E ov = __shfl_xor_sync(kFull, v, off);
    const int oid = __shfl_xor_sync(kFull, id, off);
    const E oe = __shfl_xor_sync(kFull, e, off);
    if (ov > v || (ov == v && oid < id)) {
      v = ov;
      id = oid;
      e = oe;
    }
  }
}

// The id of the r-th (0-based) member in id order from ballot masks, mask
// c * nw + w holding ids c * nt + w * kWarp + lane; N when there are fewer
// than r + 1 members. Every lane of the calling warp gets the same id.
__device__ __forceinline__ int nth_member(const unsigned* masks, int nmask, int nw, int nt, int lane, long long r,
                                          int N) {
  long long base = 0;
  for (int m0 = 0; m0 < nmask; m0 += kWarp) {
    const int mi = m0 + lane;
    const unsigned mk = mi < nmask ? masks[mi] : 0u;
    const int cnt = __popc(mk);
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += v;
    }
    const int total = __shfl_sync(kFull, inc, kWarp - 1);
    const long long lo = base + (inc - cnt);
    const unsigned who = __ballot_sync(kFull, r >= lo && r < base + inc);
    if (who) {
      const int src = __ffs(who) - 1;
      int bit = 0;
      if (lane == src) {
        unsigned rest = mk;
        for (long long q = lo; q < r; ++q) rest &= rest - 1;
        bit = __ffs(rest) - 1;
      }
      bit = __shfl_sync(kFull, bit, src);
      const int m = m0 + src;
      return (m / nw) * nt + (m % nw) * kWarp + bit;
    }
    base += total;
  }
  return N;
}

template <typename T, typename E, int D, int V, bool kShared, bool kSwap, bool kBias>
__global__ void __launch_bounds__(kMaxThreads)
seq_disp_sweep_kernel(Args a, Layout lay, SwapArgs w) {
  static_assert(kSwap || !kBias, "the EnergyBias variant is a swap variant");
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, S = a.S, M = a.M, steps = a.steps;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kWarp - 1), warp = tid / kWarp, nw = nt / kWarp;
  const int ss = S * S;
  const T* table = static_cast<const T*>(a.table);
  const int64_t* species = static_cast<const int64_t*>(a.species) + static_cast<size_t>(b) * N;

  T* s_tab = reinterpret_cast<T*>(smem + lay.tab);
  T* s_rmax = s_tab + kFields * ss;
  int* s_kind = reinterpret_cast<int*>(s_rmax + S);
  int* s_ipl_n = s_kind + ss;
  T* s_sigma = reinterpret_cast<T*>(smem + lay.move);
  T* s_s2 = s_sigma + M;
  T* s_hlog = s_s2 + M;
  T* s_red = reinterpret_cast<T*>(smem + lay.red);
  T* s_pos = reinterpret_cast<T*>(smem + lay.pos);                  // shared mode
  signed char* s_sp = reinterpret_cast<signed char*>(smem + lay.sp);  // shared mode
  T* g_pos = static_cast<T*>(a.pos_out) + static_cast<size_t>(b) * N * D;
  const T* g_in = static_cast<const T*>(a.pos_in) + static_cast<size_t>(b) * N * D;
  // swap variants: the move table, species counts, theta, the reduction
  // buffers, the rank masks, the working species (L2 mode)
  int* s_mv = reinterpret_cast<int*>(smem + lay.kinds);
  int* s_count = s_mv + 3 * M;
  T* s_theta = reinterpret_cast<T*>(smem + lay.theta);
  E* s_rx = reinterpret_cast<E*>(smem + lay.redx);
  int* s_rxi = reinterpret_cast<int*>(s_rx + 2 * kSlots * kWarp);
  unsigned* s_masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  int64_t* g_sp = kSwap ? static_cast<int64_t*>(w.species_out) + static_cast<size_t>(b) * N : nullptr;

  for (int k = tid; k < kFields * ss; k += nt) s_tab[k] = table[k];
  for (int k = tid; k < ss; k += nt) {
    s_kind[k] = static_cast<int>(table[F_KIND * ss + k]);
    s_ipl_n[k] = static_cast<int>(table[F_IPL_N * ss + k]);
  }
  for (int k = tid; k < S; k += nt) {
    T m = table[F_RCUT2 * ss + k * S];
    for (int j = 1; j < S; ++j) m = max(m, table[F_RCUT2 * ss + k * S + j]);
    s_rmax[k] = m;
  }
  // per move, as the plain step: s2 = sigma^2, D * log(2 pi s2) / 2
  for (int m = tid; m < M; m += nt) {
    const T sg = static_cast<const T*>(a.sigma)[static_cast<size_t>(b) * M + m];
    const T s2 = mul_rn(sg, sg);
    s_sigma[m] = sg;
    s_s2[m] = s2;
    s_hlog[m] = T(D) * log(mul_rn(T(6.283185307179586), s2)) / T(2);
  }
  if constexpr (kSwap) {
    for (int k = tid; k < 3 * M; k += nt) s_mv[k] = static_cast<const int*>(w.moves)[k];
    for (int k = tid; k < S; k += nt) s_count[k] = 0;
  }
  if constexpr (kBias) {
    for (int k = tid; k < 2 * M; k += nt) s_theta[k] = static_cast<const T*>(w.theta)[static_cast<size_t>(b) * 2 * M + k];
  }
  // the chain's positions: into shared memory, or copied into the working copy
  for (int j = tid; j < N; j += nt) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T x = g_in[static_cast<size_t>(j) * D + k];
      if (kShared) s_pos[k * N + j] = x;
      else g_pos[static_cast<size_t>(j) * D + k] = x;
    }
    if (kShared) s_sp[j] = static_cast<signed char>(species[j]);
    else if (kSwap) g_sp[j] = species[j];
  }
  __syncthreads();

  auto pos_of = [&](int j, int k) -> T {
    return kShared ? s_pos[k * N + j] : g_pos[static_cast<size_t>(j) * D + k];
  };
  auto species_of = [&](int j) -> int {
    if constexpr (kShared) return static_cast<int>(s_sp[j]);
    else if constexpr (kSwap) return static_cast<int>(g_sp[j]);
    else return static_cast<int>(species[j]);
  };
  auto set_species = [&](int j, int s) {
    if constexpr (kShared) s_sp[j] = static_cast<signed char>(s);
    else g_sp[j] = s;
  };

  T L[D], invL[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    L[k] = static_cast<const T*>(a.box)[b * D + k];
    invL[k] = T(1) / L[k];
  }
  auto row_of = [&](int s) -> Row<T> {
    const int off = s * S;
    return Row<T>{s_tab + F_EPS4 * ss + off, s_tab + F_SIGMA2 * ss + off,
                  s_tab + F_RCUT2 * ss + off, s_tab + F_SHIFT * ss + off,
                  s_tab + F_C0 * ss + off,    s_tab + F_C2S2 * ss + off,
                  s_tab + F_C4S4 * ss + off,  s_kind + off,
                  s_ipl_n + off};
  };
  // the pair term of row `row` with species s at r2 (0 beyond its cutoff)
  auto term = [&](const Row<T>& row, int s, T r2) -> T {
    return r2 <= row.rcut2[s] ? potential<T, V, Q_DIVIDE>(r2, load_pair<T, V>(row, s)) : T(0);
  };
  // squared minimum-image distance of particle k (at p) from x; a product
  // with 1 / L in place of the quotient can pick the other image only at
  // |dx| = L / 2, beyond any cutoff
  auto dist2 = [&](const T* p, const T* x) -> T {
    T r2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      T dx = p[k] - x[k];
      dx = dx - rint(dx * invL[k]) * L[k];
      r2 = r2 + dx * dx;
    }
    return r2;
  };

  // the species counts (swap variants) and per-particle energies (kBias)
  E* e_cur = nullptr;
  E* e_nxt = nullptr;
  if constexpr (kSwap) {
    for (int j = tid; j < N; j += nt) atomicAdd(&s_count[species_of(j)], 1);
    __syncthreads();
  }
  if constexpr (kBias) {
    E* e0 = kShared ? reinterpret_cast<E*>(smem + lay.e) : static_cast<E*>(w.e_scratch) + static_cast<size_t>(b) * 2 * N;
    e_cur = e0;
    e_nxt = e0 + N;
    // kStartRows of the thread's particles at a time against every j, each
    // summed over j in order: one read of j for several independent sums
    for (int k0 = tid; k0 < N; k0 += kStartRows * nt) {
      int kk[kStartRows], sk[kStartRows];
      T xk[kStartRows][D], rmax[kStartRows];
      E acc[kStartRows];
#pragma unroll
      for (int q = 0; q < kStartRows; ++q) {
        kk[q] = k0 + q * nt;
        const int k = kk[q] < N ? kk[q] : k0;
        sk[q] = species_of(k);
        rmax[q] = kk[q] < N ? s_rmax[sk[q]] : T(-1);  // a row past N sums nothing
#pragma unroll
        for (int d = 0; d < D; ++d) xk[q][d] = pos_of(k, d);
        acc[q] = E(0);
      }
      for (int j = 0; j < N; ++j) {
        T pj[D];
#pragma unroll
        for (int d = 0; d < D; ++d) pj[d] = pos_of(j, d);
#pragma unroll
        for (int q = 0; q < kStartRows; ++q) {
          const T r2 = dist2(pj, xk[q]);
          if (j != kk[q] && r2 <= rmax[q]) acc[q] += static_cast<E>(term(row_of(sk[q]), species_of(j), r2));
        }
      }
#pragma unroll
      for (int q = 0; q < kStartRows; ++q) {
        if (kk[q] < N) e_cur[kk[q]] = acc[q];
      }
    }
  }

  const T temp = static_cast<const T*>(a.temperature)[b];
  E ledger = static_cast<const E*>(a.energy_in)[b];
  const size_t row0 = static_cast<size_t>(b) * steps;
  const int64_t* g_move = static_cast<const int64_t*>(a.move) + row0;
  // a swap pool without displacements has no pick and normal draws
  const int64_t* g_pick = kSwap && !a.pick ? nullptr : static_cast<const int64_t*>(a.pick) + row0;
  const T* g_normal = kSwap && !a.normal ? nullptr : static_cast<const T*>(a.normal) + row0 * D;
  const T* g_u = static_cast<const T*>(a.u) + row0;
  int64_t* g_acc = static_cast<int64_t*>(a.accepts) + row0;
  const int64_t* g_r1 = kSwap && w.r1 ? static_cast<const int64_t*>(w.r1) + row0 : nullptr;
  const int64_t* g_r2 = kSwap && w.r2 ? static_cast<const int64_t*>(w.r2) + row0 : nullptr;
  const T* g_gumbel = kBias ? static_cast<const T*>(w.gumbel) + row0 * 2 * N : nullptr;

  // the next step's draws, loaded one step ahead; ids clamped for memory
  // safety only (the wrapper's callers draw them in range)
  int nx_i = 0, nx_m = 0, nx_kind = M_DISPLACEMENT;
  long long nx_r1 = 0, nx_r2 = 0;
  T nx_n[D], nx_u = T(1);
  if constexpr (kSwap) {
#pragma unroll
    for (int k = 0; k < D; ++k) nx_n[k] = T(0);
  }
  auto load_step = [&](int s) {
    if constexpr (kSwap) {
      const int64_t m = g_move[s];
      nx_m = static_cast<int>(m < 0 ? 0 : (m >= M ? M - 1 : m));
      nx_kind = s_mv[3 * nx_m];
      if (nx_kind == M_DISPLACEMENT && g_normal) {
        const int64_t i = g_pick[s];
        nx_i = static_cast<int>(i < 0 ? 0 : (i >= N ? N - 1 : i));
#pragma unroll
        for (int k = 0; k < D; ++k) nx_n[k] = g_normal[static_cast<size_t>(s) * D + k];
      } else if (nx_kind == M_DOUBLE_UNIFORM && g_r1) {
        nx_r1 = g_r1[s];
        nx_r2 = g_r2[s];
      }
    } else {
      const int64_t i = g_pick[s], m = g_move[s];
      nx_i = static_cast<int>(i < 0 ? 0 : (i >= N ? N - 1 : i));
      nx_m = static_cast<int>(m < 0 ? 0 : (m >= M ? M - 1 : m));
#pragma unroll
      for (int k = 0; k < D; ++k) nx_n[k] = g_normal[static_cast<size_t>(s) * D + k];
    }
    nx_u = g_u[s];
  };
  if (steps > 0) load_step(0);

  int last = -1;  // the last accepted step's particle, and its position
  T last_x[D];
#pragma unroll
  for (int k = 0; k < D; ++k) last_x[k] = T(0);
  // swap variants: the last accepted swap's particles and their new species
  int sw_i = -1, sw_j = -1, sw_si = 0, sw_sj = 0;
  auto species_now = [&](int j) -> int {
    if constexpr (kSwap) return j == sw_i ? sw_si : (j == sw_j ? sw_sj : species_of(j));
    else return species_of(j);
  };
  // swap variants: the next reduction's buffers (two, alternating)
  int nred = 0;
  auto next_red = [&](E*& rx, int*& ri) {
    rx = s_rx + (nred & 1) * kSlots * kWarp;
    ri = s_rxi + (nred & 1) * kIntSlots * kWarp;
    ++nred;
  };
  auto accept_swap = [&](bool accept, int i, int j, int si, int sj, bool inf_old, T de, E e2i, E e2j) {
    if (!accept) return;
    if (i % nt == tid) set_species(i, sj);
    if (j % nt == tid) set_species(j, si);
    if constexpr (kBias) {
      if (i % nt == tid) e_nxt[i] = e2i;
      if (j % nt == tid) e_nxt[j] = e2j;
      E* t = e_cur;
      e_cur = e_nxt;
      e_nxt = t;
    }
    sw_i = i;
    sw_si = sj;
    sw_j = j;
    sw_sj = si;
    if (!inf_old) ledger = ledger + static_cast<E>(de);
  };
  // a swap's pair terms over this thread's particles other than i and j: dE
  // (T), whether an old or a new term is infinite (the (i, j) term counts in
  // both), and with kBias the next energies of those particles and the
  // touched rows' changes in E; `each(k, sk, e2_k)` sees every such particle
  struct SwapSums {
    T de;
    int inf_old, inf_new;
    E di, dj;
  };
  auto swap_terms = [&](int i, int j, int si, int sj, auto each) -> SwapSums {
    SwapSums r{T(0), 0, 0, E(0), E(0)};
    const bool two = j != i;
    T xi[D], xj[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xi[d] = pos_of(i, d);
      xj[d] = pos_of(j, d);
    }
    const Row<T> ra = row_of(si), rb = row_of(sj);
    const T rmax = max(s_rmax[si], s_rmax[sj]);
    for (int k = tid; k < N; k += nt) {
      const int sk = species_of(k);
      T pk[D];
#pragma unroll
      for (int d = 0; d < D; ++d) pk[d] = pos_of(k, d);
      const T r2i = dist2(pk, xi);
      if (k == i) continue;
      if (k == j) {
        const T u = term(ra, sj, r2i);
        r.inf_old |= isinf(u);
        r.inf_new |= isinf(u);
        continue;
      }
      T oi = T(0), ni = T(0), oj = T(0), nj = T(0);
      if (r2i <= rmax) {
        oi = term(ra, sk, r2i);
        ni = term(rb, sk, r2i);
      }
      if (two) {
        const T r2j = dist2(pk, xj);
        if (r2j <= rmax) {
          oj = term(rb, sk, r2j);
          nj = term(ra, sk, r2j);
        }
      }
      r.de += (ni - oi) + (nj - oj);
      r.inf_old |= isinf(oi) | isinf(oj);
      r.inf_new |= isinf(ni) | isinf(nj);
      if constexpr (kBias) {
        const E dki = static_cast<E>(ni) - static_cast<E>(oi);
        const E dkj = static_cast<E>(nj) - static_cast<E>(oj);
        r.di += dki;
        r.dj += dkj;
        const E e2 = e_cur[k] + (dki + dkj);
        e_nxt[k] = e2;
        each(k, sk, e2);
      }
    }
    return r;
  };

  for (int s = 0; s < steps; ++s) {
    const int i = nx_i, mv = nx_m;
    T nrm[D];
#pragma unroll
    for (int k = 0; k < D; ++k) nrm[k] = nx_n[k];
    const T logu = log(nx_u);
    [[maybe_unused]] const int kind = nx_kind;
    [[maybe_unused]] const long long rk1 = nx_r1, rk2 = nx_r2;
    if (s + 1 < steps) load_step(s + 1);

    if constexpr (kSwap) {
      if (kind == M_DOUBLE_UNIFORM) {
        const int s1 = s_mv[3 * mv + 1], s2 = s_mv[3 * mv + 2];
        const long long n1 = s_count[s1], n2 = s_count[s2];
        bool accept = false;
        if (n1 > 0 && n2 > 0) {
          // the partners: ranks among the current members, in id order
          const int chunks = (N + nt - 1) / nt, nmask = chunks * nw;
          for (int c = 0; c < chunks; ++c) {
            const int k = c * nt + tid;
            const int sk = k < N ? species_of(k) : -1;
            const unsigned b1 = __ballot_sync(kFull, sk == s1), b2 = __ballot_sync(kFull, sk == s2);
            if (lane == 0) {
              s_masks[c * nw + warp] = b1;
              s_masks[nmask + c * nw + warp] = b2;
            }
          }
          __syncthreads();
          const int pi = min(nth_member(s_masks, nmask, nw, nt, lane, rk1, N), N - 1);
          const int pj = min(nth_member(s_masks + nmask, nmask, nw, nt, lane, rk2, N), N - 1);
          const int si = species_of(pi), sj = species_of(pj);
          const T lq = -log(static_cast<T>(n1 * n2));
          const SwapSums t = swap_terms(pi, pj, si, sj, [](int, int, E) {});
          E* rx;
          int* ri;
          next_red(rx, ri);
          const T ws = warp_allsum(t.de);
          const int fo = warp_allor(t.inf_old), fn = warp_allor(t.inf_new);
          E di = E(0), dj = E(0), ei = E(0), ej = E(0);
          if constexpr (kBias) {
            // the partners' energies from their owners (a sum of one term:
            // exact); only the owner reads its particle's energy, since
            // after an accepted swap it writes that slot in the next step
            di = warp_allsum(t.di);
            dj = warp_allsum(t.dj);
            ei = warp_allsum(pi % nt == tid ? e_cur[pi] : E(0));
            ej = warp_allsum(pj % nt == tid ? e_cur[pj] : E(0));
          }
          if (lane == 0) {
            rx[warp] = static_cast<E>(ws);
            if constexpr (kBias) {
              rx[kWarp + warp] = di;
              rx[2 * kWarp + warp] = dj;
              rx[3 * kWarp + warp] = ei;
              rx[4 * kWarp + warp] = ej;
            }
            ri[warp] = fo;
            ri[kWarp + warp] = fn;
          }
          __syncthreads();
          const T de = warp_allsum(lane < nw ? static_cast<T>(rx[lane]) : T(0));
          const bool inf_old = warp_allor(lane < nw ? ri[lane] : 0) != 0;
          const bool inf_new = warp_allor(lane < nw ? ri[kWarp + lane] : 0) != 0;
          E e2i = E(0), e2j = E(0);
          if constexpr (kBias) {
            e2i = warp_allsum(lane < nw ? rx[3 * kWarp + lane] : E(0)) + warp_allsum(lane < nw ? rx[kWarp + lane] : E(0));
            e2j = warp_allsum(lane < nw ? rx[4 * kWarp + lane] : E(0)) + warp_allsum(lane < nw ? rx[2 * kWarp + lane] : E(0));
          }
          accept = !inf_new && (inf_old || logu < (-de / temp + lq) - lq);
          accept_swap(accept, pi, pj, si, sj, inf_old, de, e2i, e2j);
        }
        if (tid == 0) g_acc[s] = accept ? 1 : 0;
        continue;
      }
      if constexpr (kBias) {
        if (kind == M_ENERGY_BIAS) {
          const int s1 = s_mv[3 * mv + 1], s2 = s_mv[3 * mv + 2];
          bool accept = false;
          if (s_count[s1] > 0 && s_count[s2] > 0) {
            const E th1 = static_cast<E>(s_theta[2 * mv]), th2 = static_cast<E>(s_theta[2 * mv + 1]);
            const E inf = E(INFINITY);
            const T* g0 = g_gumbel + static_cast<size_t>(s) * 2 * N;
            const T* g1 = g0 + N;
            // 1. the picks, argmax of theta e + gumbel over each species,
            //    and the maxima of theta e for the forward logsumexps
            E v1 = -inf, v2 = -inf, ev1 = E(0), ev2 = E(0), m1 = -inf, m2 = -inf;
            int id1 = N, id2 = N;
            for (int k = tid; k < N; k += nt) {
              const int sk = species_of(k);
              const E ek = e_cur[k];
              if (sk == s1) {
                const E t = th1 * ek, v = t + static_cast<E>(g0[k]);
                if (v > v1) v1 = v, id1 = k, ev1 = ek;
                m1 = t > m1 ? t : m1;
              }
              if (sk == s2) {
                const E t = th2 * ek, v = t + static_cast<E>(g1[k]);
                if (v > v2) v2 = v, id2 = k, ev2 = ek;
                m2 = t > m2 ? t : m2;
              }
            }
            E* rx;
            int* ri;
            next_red(rx, ri);
            warp_allargmax(v1, id1, ev1);
            warp_allargmax(v2, id2, ev2);
            m1 = warp_allmax(m1);
            m2 = warp_allmax(m2);
            if (lane == 0) {
              rx[warp] = v1;
              rx[kWarp + warp] = ev1;
              rx[2 * kWarp + warp] = v2;
              rx[3 * kWarp + warp] = ev2;
              rx[4 * kWarp + warp] = m1;
              rx[5 * kWarp + warp] = m2;
              ri[warp] = id1;
              ri[kWarp + warp] = id2;
            }
            __syncthreads();
            const bool in = lane < nw;
            v1 = in ? rx[lane] : -inf;
            ev1 = in ? rx[kWarp + lane] : E(0);
            id1 = in ? ri[lane] : N;
            v2 = in ? rx[2 * kWarp + lane] : -inf;
            ev2 = in ? rx[3 * kWarp + lane] : E(0);
            id2 = in ? ri[kWarp + lane] : N;
            warp_allargmax(v1, id1, ev1);
            warp_allargmax(v2, id2, ev2);
            m1 = warp_allmax(in ? rx[4 * kWarp + lane] : -inf);
            m2 = warp_allmax(in ? rx[5 * kWarp + lane] : -inf);
            const int pi = min(id1, N - 1), pj = min(id2, N - 1);
            const int si = species_of(pi), sj = species_of(pj);
            const E lm1 = isfinite(m1) ? m1 : E(0), lm2 = isfinite(m2) ? m2 : E(0);

            // 2. the swap's pair terms and next energies, the forward sums,
            //    and the maxima of theta e' over the other particles
            E f1 = E(0), f2 = E(0), mb1 = -inf, mb2 = -inf;
            for (int k = tid; k < N; k += nt) {
              const int sk = species_of(k);
              const E ek = e_cur[k];
              if (sk == s1) f1 += exp(th1 * ek - lm1);
              if (sk == s2) f2 += exp(th2 * ek - lm2);
            }
            const SwapSums t = swap_terms(pi, pj, si, sj, [&](int, int sk, E e2) {
              if (sk == s1) mb1 = th1 * e2 > mb1 ? th1 * e2 : mb1;
              if (sk == s2) mb2 = th2 * e2 > mb2 ? th2 * e2 : mb2;
            });
            next_red(rx, ri);
            const T ws = warp_allsum(t.de);
            const E di = warp_allsum(t.di), dj = warp_allsum(t.dj);
            f1 = warp_allsum(f1);
            f2 = warp_allsum(f2);
            mb1 = warp_allmax(mb1);
            mb2 = warp_allmax(mb2);
            const int fo = warp_allor(t.inf_old), fn = warp_allor(t.inf_new);
            if (lane == 0) {
              rx[warp] = static_cast<E>(ws);
              rx[kWarp + warp] = di;
              rx[2 * kWarp + warp] = dj;
              rx[3 * kWarp + warp] = f1;
              rx[4 * kWarp + warp] = f2;
              rx[5 * kWarp + warp] = mb1;
              rx[6 * kWarp + warp] = mb2;
              ri[warp] = fo;
              ri[kWarp + warp] = fn;
            }
            __syncthreads();
            const T de = warp_allsum(in ? static_cast<T>(rx[lane]) : T(0));
            const E e2i = ev1 + warp_allsum(in ? rx[kWarp + lane] : E(0));
            const E e2j = ev2 + warp_allsum(in ? rx[2 * kWarp + lane] : E(0));
            f1 = warp_allsum(in ? rx[3 * kWarp + lane] : E(0));
            f2 = warp_allsum(in ? rx[4 * kWarp + lane] : E(0));
            mb1 = warp_allmax(in ? rx[5 * kWarp + lane] : -inf);
            mb2 = warp_allmax(in ? rx[6 * kWarp + lane] : -inf);
            const bool inf_old = warp_allor(in ? ri[lane] : 0) != 0;
            const bool inf_new = warp_allor(in ? ri[kWarp + lane] : 0) != 0;
            // after the swap i holds sj and j holds si
            if (pi % nt == tid) e_nxt[pi] = e2i;
            if (pj % nt == tid) e_nxt[pj] = e2j;
            if (sj == s1) mb1 = th1 * e2i > mb1 ? th1 * e2i : mb1;
            if (sj == s2) mb2 = th2 * e2i > mb2 ? th2 * e2i : mb2;
            if (pj != pi) {
              if (si == s1) mb1 = th1 * e2j > mb1 ? th1 * e2j : mb1;
              if (si == s2) mb2 = th2 * e2j > mb2 ? th2 * e2j : mb2;
            }
            const E lb1 = isfinite(mb1) ? mb1 : E(0), lb2 = isfinite(mb2) ? mb2 : E(0);

            // 3. the reverse sums under the swapped species
            E r1 = E(0), r2 = E(0);
            for (int k = tid; k < N; k += nt) {
              const int sk = k == pi ? sj : (k == pj ? si : species_of(k));
              const E e2 = e_nxt[k];
              if (sk == s1) r1 += exp(th1 * e2 - lb1);
              if (sk == s2) r2 += exp(th2 * e2 - lb2);
            }
            next_red(rx, ri);
            r1 = warp_allsum(r1);
            r2 = warp_allsum(r2);
            if (lane == 0) {
              rx[warp] = r1;
              rx[kWarp + warp] = r2;
            }
            __syncthreads();
            r1 = warp_allsum(in ? rx[lane] : E(0));
            r2 = warp_allsum(in ? rx[kWarp + lane] : E(0));

            const E lq_fwd = ((th1 * ev1 + th2 * ev2) - (lm1 + log(f1))) - (lm2 + log(f2));
            const E lq_rev = ((th1 * e2j + th2 * e2i) - (lb1 + log(r1))) - (lb2 + log(r2));
            const E la = inf_new ? -inf
                         : inf_old ? (inf + lq_rev) - lq_fwd
                                   : (static_cast<E>(-de / temp) + lq_rev) - lq_fwd;
            accept = static_cast<E>(logu) < la;
            accept_swap(accept, pi, pj, si, sj, inf_old, de, e2i, e2j);
          }
          if (tid == 0) g_acc[s] = accept ? 1 : 0;
          continue;
        }
      }
    }

    // the proposal and its log q, in the plain step's order of operations
    const T sg = s_sigma[mv];
    T xa[D], xn[D], dd = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xa[k] = i == last ? last_x[k] : pos_of(i, k);
      const T dk = mul_rn(sg, nrm[k]);
      dd = add_rn(dd, mul_rn(dk, dk));
      xn[k] = add_rn(xa[k], dk);
    }
    const T lq = -dd / mul_rn(T(2), s_s2[mv]) - s_hlog[mv];

    const int si = species_now(i);
    const Row<T> row = row_of(si);
    const T rmax = s_rmax[si];
    T part = T(0);
    [[maybe_unused]] E dpart = E(0);
    for (int j0 = tid; j0 < N; j0 += 2 * nt) {
      int jj[2], sj[2];
      T p[2][D];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        jj[w] = j0 + w * nt;
        const int j = jj[w] < N ? jj[w] : j0;
        sj[w] = species_of(j);
#pragma unroll
        for (int k = 0; k < D; ++k) p[w][k] = pos_of(j, k);
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        T r2o = T(0), r2n = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          // minimum image; a product with 1 / L in place of the quotient
          // can pick the other image only at |dx| = L / 2, beyond any cutoff
          T dxo = p[w][k] - xa[k];
          T dxn = p[w][k] - xn[k];
          dxo = dxo - rint(dxo * invL[k]) * L[k];
          dxn = dxn - rint(dxn * invL[k]) * L[k];
          r2o = r2o + dxo * dxo;
          r2n = r2n + dxn * dxn;
        }
        if constexpr (kBias) {
          // every other particle's next energy, and the mover's change in E
          if (jj[w] < N && jj[w] != i) {
            E dk = E(0);
            if (r2o <= rmax || r2n <= rmax) {
              const T rc = row.rcut2[sj[w]];
              const PairParams<T> q = load_pair<T, V>(row, sj[w]);
              const T un = r2n <= rc ? potential<T, V, Q_DIVIDE>(r2n, q) : T(0);
              const T uo = r2o <= rc ? potential<T, V, Q_DIVIDE>(r2o, q) : T(0);
              part += un - uo;
              dk = static_cast<E>(un) - static_cast<E>(uo);
              dpart += dk;
            }
            e_nxt[jj[w]] = e_cur[jj[w]] + dk;
          }
        } else {
          // beyond the row's largest cutoff both terms are 0: skip the rest
          if (jj[w] < N && jj[w] != i && (r2o <= rmax || r2n <= rmax)) {
            const T rc = row.rcut2[sj[w]];
            const PairParams<T> q = load_pair<T, V>(row, sj[w]);
            const T un = r2n <= rc ? potential<T, V, Q_DIVIDE>(r2n, q) : T(0);
            const T uo = r2o <= rc ? potential<T, V, Q_DIVIDE>(r2o, q) : T(0);
            part += un - uo;
          }
        }
      }
    }

    T de;
    [[maybe_unused]] E dmover = E(0);
    if constexpr (kSwap) {
      E* rx;
      int* ri;
      next_red(rx, ri);
      const T wsum = warp_allsum(part);
      if constexpr (kBias) dpart = warp_allsum(dpart);
      if (lane == 0) {
        rx[warp] = static_cast<E>(wsum);
        if constexpr (kBias) rx[kWarp + warp] = dpart;
      }
      __syncthreads();
      de = warp_allsum(lane < nw ? static_cast<T>(rx[lane]) : T(0));
      if constexpr (kBias) dmover = warp_allsum(lane < nw ? rx[kWarp + lane] : E(0));
    } else {
      T* red = s_red + (s & 1) * kWarp;
      const T wsum = warp_allsum(part);
      if (lane == 0) red[warp] = wsum;
      __syncthreads();
      de = warp_allsum(lane < nw ? red[lane] : T(0));
    }

    const T log_alpha = (-de / temp + lq) - lq;
    const bool accept = isfinite(de) && logu < log_alpha;
    if (accept) {
      if (i % nt == tid) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (kShared) s_pos[k * N + i] = xn[k];
          else g_pos[static_cast<size_t>(i) * D + k] = xn[k];
        }
        if constexpr (kBias) e_nxt[i] = e_cur[i] + dmover;
      }
      if constexpr (kBias) {
        E* t = e_cur;
        e_cur = e_nxt;
        e_nxt = t;
      }
      last = i;
#pragma unroll
      for (int k = 0; k < D; ++k) last_x[k] = xn[k];
      ledger = ledger + static_cast<E>(de);
    }
    if (tid == 0) g_acc[s] = accept ? 1 : 0;
  }

  if (kShared) {
    __syncthreads();
    for (int j = tid; j < N; j += nt) {
#pragma unroll
      for (int k = 0; k < D; ++k) g_pos[static_cast<size_t>(j) * D + k] = s_pos[k * N + j];
      if constexpr (kSwap) g_sp[j] = s_sp[j];
    }
  }
  if (tid == 0) static_cast<E*>(a.energy_out)[b] = ledger;
}

int optin_smem(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

template <typename T, typename E, bool kSwap, bool kBias>
Layout plan_layout(int D, int N, int S, int M, int threads, bool shared) {
  if constexpr (kSwap) return make_swap_layout<T, E>(D, N, S, M, threads, shared, kBias);
  else return make_layout<T>(D, N, S, M, shared);
}

// The plan: shared mode where the chain fits beside the table, else L2 mode.
template <typename T, typename E, bool kSwap, bool kBias>
int make_plan(int D, int N, int S, int M, int threads, Layout* lay, int* shared) {
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp) return kErrThreads;
  int optin = 0;
  const int err = optin_smem(&optin);
  if (err != 0) return err;
  *lay = plan_layout<T, E, kSwap, kBias>(D, N, S, M, threads, true);
  *shared = lay->total <= static_cast<size_t>(optin);
  if (!*shared) *lay = plan_layout<T, E, kSwap, kBias>(D, N, S, M, threads, false);
  return lay->total <= static_cast<size_t>(optin) ? 0 : kErrSharedMemory;
}

template <typename T, typename E, int D, int V, bool kShared, bool kSwap, bool kBias>
int launch(const Args& a, const Layout& lay, const SwapArgs& w, int threads, cudaStream_t stream) {
  auto* kernel = seq_disp_sweep_kernel<T, E, D, V, kShared, kSwap, kBias>;
  if (lay.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(lay.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.B > 0) kernel<<<a.B, threads, lay.total, stream>>>(a, lay, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E, int D, int V, bool kSwap, bool kBias>
int launch_mode(const Args& a, const SwapArgs& w, int threads, cudaStream_t stream) {
  Layout lay;
  int shared = 0;
  const int err = make_plan<T, E, kSwap, kBias>(D, a.N, a.S, a.M, threads, &lay, &shared);
  if (err != 0) return err;
  return shared ? launch<T, E, D, V, true, kSwap, kBias>(a, lay, w, threads, stream)
                : launch<T, E, D, V, false, kSwap, kBias>(a, lay, w, threads, stream);
}

template <typename T, typename E, int D, bool kSwap, bool kBias>
int launch_variant(int variant, const Args& a, const SwapArgs& w, int threads, cudaStream_t stream) {
  switch (variant) {
    case V_GENERIC: return launch_mode<T, E, D, V_GENERIC, kSwap, kBias>(a, w, threads, stream);
    case V_INVERSE_POWER: return launch_mode<T, E, D, V_INVERSE_POWER, kSwap, kBias>(a, w, threads, stream);
    case V_LENNARD_JONES: return launch_mode<T, E, D, V_LENNARD_JONES, kSwap, kBias>(a, w, threads, stream);
    case V_SMOOTH_LJ: return launch_mode<T, E, D, V_SMOOTH_LJ, kSwap, kBias>(a, w, threads, stream);
    default: return kErrUnsupported;
  }
}

template <typename T, typename E, bool kSwap, bool kBias>
int launch_dim(int d, int variant, const Args& a, const SwapArgs& w, int threads, cudaStream_t stream) {
  if (d == 2) return launch_variant<T, E, 2, kSwap, kBias>(variant, a, w, threads, stream);
  if (d == 3) return launch_variant<T, E, 3, kSwap, kBias>(variant, a, w, threads, stream);
  return kErrUnsupported;
}

// the positions' and the ledger's types: float64 with float64, float32 with
// float64 (mixed precision) or float32 with float32
template <bool kSwap, bool kBias>
int launch_types(int is_f64, int ledger_f64, int d, int variant, const Args& a, const SwapArgs& w, int threads,
                 cudaStream_t stream) {
  if (is_f64 && ledger_f64) return launch_dim<double, double, kSwap, kBias>(d, variant, a, w, threads, stream);
  if (!is_f64 && ledger_f64) return launch_dim<float, double, kSwap, kBias>(d, variant, a, w, threads, stream);
  if (!is_f64 && !ledger_f64) return launch_dim<float, float, kSwap, kBias>(d, variant, a, w, threads, stream);
  return kErrUnsupported;
}

template <bool kSwap, bool kBias>
int plan_types(int is_f64, int ledger_f64, int d, int N, int S, int M, int threads, long long* smem, int* shared) {
  if (d != 2 && d != 3) return kErrUnsupported;
  Layout lay;
  int err = kErrUnsupported;
  if (is_f64 && ledger_f64) err = make_plan<double, double, kSwap, kBias>(d, N, S, M, threads, &lay, shared);
  if (!is_f64 && ledger_f64) err = make_plan<float, double, kSwap, kBias>(d, N, S, M, threads, &lay, shared);
  if (!is_f64 && !ledger_f64) err = make_plan<float, float, kSwap, kBias>(d, N, S, M, threads, &lay, shared);
  if (err != 0) return err;
  *smem = static_cast<long long>(lay.total);
  return 0;
}

const char* error_string(int code) {
  if (code == kErrUnsupported) return "unsupported dtype, dimension or potential variant";
  if (code == kErrSharedMemory) return "the pair table does not fit in shared memory";
  if (code == kErrThreads) return "threads per block must be a multiple of 32 in [32, 512]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace

// The entry points of either library. is_f64: float64 positions (else
// float32); ledger_f64: a float64 ledger (float32 positions with it: mixed
// precision). `variant`: 0 for any mix of kinds, else the one kind of the
// table (1 inverse power, 2 Lennard-Jones, 3 smooth LJ). `swaps` 1 for a pool
// with a swap (the swap library only), `bias` 1 for one with an EnergyBias
// swap; the swap inputs and species_out are null without swaps, theta, gumbel
// and e_scratch without EnergyBias. `threads`: a multiple of 32, at most 512.
extern "C" int seq_sweep(int is_f64, int ledger_f64, int d, int variant, int swaps, int bias, const void* pos_in,
                         const void* species, const void* box, const void* temperature, const void* energy_in,
                         const void* table, const void* sigma, const void* move, const void* pick,
                         const void* normal, const void* u, const void* moves, const void* theta, const void* r1,
                         const void* r2, const void* gumbel, int B, int N, int S, int M, int steps, int threads,
                         void* pos_out, void* species_out, void* energy_out, void* accepts, void* e_scratch,
                         void* stream_ptr) {
  const Args a{pos_in, species, box, temperature, energy_in, table, sigma, move, pick, normal, u,
               B, N, S, M, steps, pos_out, energy_out, accepts};
  const SwapArgs w{moves, theta, r1, r2, gumbel, species_out, e_scratch};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#if SEQ_SWEEP_SWAPS
  if (!swaps) return kErrUnsupported;
  return bias ? launch_types<true, true>(is_f64, ledger_f64, d, variant, a, w, threads, stream)
              : launch_types<true, false>(is_f64, ledger_f64, d, variant, a, w, threads, stream);
#else
  if (swaps || bias) return kErrUnsupported;
  return launch_types<false, false>(is_f64, ledger_f64, d, variant, a, w, threads, stream);
#endif
}

// The launcher's choice for these shapes: dynamic shared memory bytes of a
// block and whether the chain's positions live in it (1) or in L2 (0).
extern "C" int seq_sweep_plan(int is_f64, int ledger_f64, int swaps, int bias, int d, int N, int S, int M,
                              int threads, long long* smem, int* shared) {
#if SEQ_SWEEP_SWAPS
  if (!swaps) return kErrUnsupported;
  return bias ? plan_types<true, true>(is_f64, ledger_f64, d, N, S, M, threads, smem, shared)
              : plan_types<true, false>(is_f64, ledger_f64, d, N, S, M, threads, smem, shared);
#else
  if (swaps || bias) return kErrUnsupported;
  return plan_types<false, false>(is_f64, ledger_f64, d, N, S, M, threads, smem, shared);
#endif
}

extern "C" const char* seq_error_string(int code) { return error_string(code); }

// Sequential displacement sweep: every step of one sweep of the sequential
// Metropolis kernel, for every chain, in one launch.
//
// Replaces no TPU kernel: the JAX package runs the sequential step as XLA ops
// (particlesmc_tpu/moves/kernel.py), and the port ran it as ~113 small
// PyTorch launches per step. This kernel takes the pools whose every move is
// a Gaussian displacement, with the dense energy change, on atomic systems.
// The Python wrapper and its contract are in particlesmc_tpu_torch/moves/seq_cuda.py;
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
//
// Per chain and step, in order: delta = sigma[move] * normal; the energy
// change dE = sum over j != i of u(r2(x_j - x_new)) - u(r2(x_j - x_old)), each
// r2 the minimum image in the chain's box; log q of the symmetric Gaussian
// enters as (-dE / T + log q) - log q, as in the plain step; accept iff dE is
// finite and log u < that. A dE with an infinite term is not finite and
// rejects, as it does in the plain step (there e_i + 0 * e_i is NaN), so an
// accepted step always books its dE. On accept particle i moves, unwrapped.
//
// What bounds it: latency. A step reads a few hundred bytes and does about
// 30 N operations, but each step of a chain depends on the one before, and
// ends in a reduction over the block. So the time is the length of that chain
// of dependent steps: the pair loop's instructions per thread, one block
// barrier, two warp butterflies.
//
// Design: one block per chain for the whole sweep. Its positions (as [D][N])
// and species (int8) live in shared memory when they fit, else the chain's
// working copy in pos_out is read through L1/L2. Thread t owns particles
// t, t + blockDim, ... and is the only thread that reads or writes them in
// the pair loop. A step: every thread sums its pairs (two per iteration; a
// pair beyond the mover's row's largest cutoff at both positions skips the
// potential), a warp butterfly, lane 0 writes its warp's sum to one of two
// buffers (by step parity), one block barrier, then every warp sums the
// buffer with the same butterfly, so every thread holds the same dE bits and
// takes the same decision: no second barrier. The owner of i writes its new
// position; every thread keeps the last accepted move's particle and position
// in registers, since the next step may read that particle before a barrier
// has passed. The next step's draws are loaded during the current one. No
// atomics and a fixed reduction order: a launch is bitwise reproducible.
// The potential (pair_terms.cuh) is a template on the kinds in the table (one
// variant per kind, and a generic one for any mix) and divides sigma2 by r2,
// as the plain step does.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_terms.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kErrThreads = -3;

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

struct Args {
  const void *pos_in, *species, *box, *temperature, *energy_in, *table, *sigma, *move, *pick, *normal, *u;
  int B, N, S, M, steps;
  void *pos_out, *energy_out, *accepts;
};

template <typename T, typename E, int D, int V, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
seq_disp_sweep_kernel(Args a, Layout lay) {
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
  // the chain's positions: into shared memory, or copied into the working copy
  for (int j = tid; j < N; j += nt) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T x = g_in[static_cast<size_t>(j) * D + k];
      if (kShared) s_pos[k * N + j] = x;
      else g_pos[static_cast<size_t>(j) * D + k] = x;
    }
    if (kShared) s_sp[j] = static_cast<signed char>(species[j]);
  }
  __syncthreads();

  auto pos_of = [&](int j, int k) -> T {
    return kShared ? s_pos[k * N + j] : g_pos[static_cast<size_t>(j) * D + k];
  };
  auto species_of = [&](int j) -> int {
    return kShared ? static_cast<int>(s_sp[j]) : static_cast<int>(species[j]);
  };

  T L[D], invL[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    L[k] = static_cast<const T*>(a.box)[b * D + k];
    invL[k] = T(1) / L[k];
  }
  const T temp = static_cast<const T*>(a.temperature)[b];
  E ledger = static_cast<const E*>(a.energy_in)[b];
  const size_t row0 = static_cast<size_t>(b) * steps;
  const int64_t* g_move = static_cast<const int64_t*>(a.move) + row0;
  const int64_t* g_pick = static_cast<const int64_t*>(a.pick) + row0;
  const T* g_normal = static_cast<const T*>(a.normal) + row0 * D;
  const T* g_u = static_cast<const T*>(a.u) + row0;
  int64_t* g_acc = static_cast<int64_t*>(a.accepts) + row0;

  // the next step's draws, loaded one step ahead; ids clamped for memory
  // safety only (the wrapper's callers draw them in range)
  int nx_i = 0, nx_m = 0;
  T nx_n[D], nx_u = T(1);
  auto load_step = [&](int s) {
    const int64_t i = g_pick[s], m = g_move[s];
    nx_i = static_cast<int>(i < 0 ? 0 : (i >= N ? N - 1 : i));
    nx_m = static_cast<int>(m < 0 ? 0 : (m >= M ? M - 1 : m));
#pragma unroll
    for (int k = 0; k < D; ++k) nx_n[k] = g_normal[static_cast<size_t>(s) * D + k];
    nx_u = g_u[s];
  };
  if (steps > 0) load_step(0);

  int last = -1;  // the last accepted step's particle, and its position
  T last_x[D];
#pragma unroll
  for (int k = 0; k < D; ++k) last_x[k] = T(0);

  for (int s = 0; s < steps; ++s) {
    const int i = nx_i, mv = nx_m;
    T nrm[D];
#pragma unroll
    for (int k = 0; k < D; ++k) nrm[k] = nx_n[k];
    const T logu = log(nx_u);
    if (s + 1 < steps) load_step(s + 1);

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

    const int si = species_of(i);
    const int off = si * S;
    const Row<T> row{s_tab + F_EPS4 * ss + off, s_tab + F_SIGMA2 * ss + off,
                     s_tab + F_RCUT2 * ss + off, s_tab + F_SHIFT * ss + off,
                     s_tab + F_C0 * ss + off,    s_tab + F_C2S2 * ss + off,
                     s_tab + F_C4S4 * ss + off,  s_kind + off,
                     s_ipl_n + off};
    const T rmax = s_rmax[si];
    T part = T(0);
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

    T* red = s_red + (s & 1) * kWarp;
    const T wsum = warp_allsum(part);
    if (lane == 0) red[warp] = wsum;
    __syncthreads();
    const T de = warp_allsum(lane < nw ? red[lane] : T(0));

    const T log_alpha = (-de / temp + lq) - lq;
    const bool accept = isfinite(de) && logu < log_alpha;
    if (accept) {
      if (i % nt == tid) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (kShared) s_pos[k * N + i] = xn[k];
          else g_pos[static_cast<size_t>(i) * D + k] = xn[k];
        }
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

// The plan: shared mode where the chain fits beside the table, else L2 mode.
template <typename T>
int make_plan(int D, int N, int S, int M, int threads, Layout* lay, int* shared) {
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp) return kErrThreads;
  int optin = 0;
  const int err = optin_smem(&optin);
  if (err != 0) return err;
  *lay = make_layout<T>(D, N, S, M, true);
  *shared = lay->total <= static_cast<size_t>(optin);
  if (!*shared) *lay = make_layout<T>(D, N, S, M, false);
  return lay->total <= static_cast<size_t>(optin) ? 0 : kErrSharedMemory;
}

template <typename T, typename E, int D, int V, bool kShared>
int launch(const Args& a, const Layout& lay, int threads, cudaStream_t stream) {
  if (lay.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(seq_disp_sweep_kernel<T, E, D, V, kShared>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(lay.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.B > 0) seq_disp_sweep_kernel<T, E, D, V, kShared><<<a.B, threads, lay.total, stream>>>(a, lay);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E, int D, int V>
int launch_mode(const Args& a, int threads, cudaStream_t stream) {
  Layout lay;
  int shared = 0;
  const int err = make_plan<T>(D, a.N, a.S, a.M, threads, &lay, &shared);
  if (err != 0) return err;
  return shared ? launch<T, E, D, V, true>(a, lay, threads, stream)
                : launch<T, E, D, V, false>(a, lay, threads, stream);
}

template <typename T, typename E, int D>
int launch_variant(int variant, const Args& a, int threads, cudaStream_t stream) {
  switch (variant) {
    case V_GENERIC: return launch_mode<T, E, D, V_GENERIC>(a, threads, stream);
    case V_INVERSE_POWER: return launch_mode<T, E, D, V_INVERSE_POWER>(a, threads, stream);
    case V_LENNARD_JONES: return launch_mode<T, E, D, V_LENNARD_JONES>(a, threads, stream);
    case V_SMOOTH_LJ: return launch_mode<T, E, D, V_SMOOTH_LJ>(a, threads, stream);
    default: return kErrUnsupported;
  }
}

template <typename T, typename E>
int launch_dim(int d, int variant, const Args& a, int threads, cudaStream_t stream) {
  if (d == 2) return launch_variant<T, E, 2>(variant, a, threads, stream);
  if (d == 3) return launch_variant<T, E, 3>(variant, a, threads, stream);
  return kErrUnsupported;
}

}  // namespace

// is_f64: float64 positions (else float32); ledger_f64: a float64 ledger
// (float32 positions with it: mixed precision). `variant`: 0 for any mix of
// kinds, else the one kind of the table (1 inverse power, 2 Lennard-Jones,
// 3 smooth LJ). `threads`: a multiple of 32, at most 512.
extern "C" int seq_disp_sweep(int is_f64, int ledger_f64, int d, int variant, const void* pos_in,
                              const void* species, const void* box, const void* temperature,
                              const void* energy_in, const void* table, const void* sigma,
                              const void* move, const void* pick, const void* normal, const void* u,
                              int B, int N, int S, int M, int steps, int threads, void* pos_out,
                              void* energy_out, void* accepts, void* stream_ptr) {
  const Args a{pos_in, species, box, temperature, energy_in, table, sigma, move, pick, normal, u,
               B, N, S, M, steps, pos_out, energy_out, accepts};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f64 && ledger_f64) return launch_dim<double, double>(d, variant, a, threads, stream);
  if (!is_f64 && ledger_f64) return launch_dim<float, double>(d, variant, a, threads, stream);
  if (!is_f64 && !ledger_f64) return launch_dim<float, float>(d, variant, a, threads, stream);
  return kErrUnsupported;
}

// The launcher's choice for these shapes: dynamic shared memory bytes of a
// block and whether the chain's positions live in it (1) or in L2 (0).
extern "C" int seq_disp_sweep_plan(int is_f64, int d, int N, int S, int M, int threads,
                                   long long* smem, int* shared) {
  if (d != 2 && d != 3) return kErrUnsupported;
  Layout lay;
  const int err = is_f64 ? make_plan<double>(d, N, S, M, threads, &lay, shared)
                         : make_plan<float>(d, N, S, M, threads, &lay, shared);
  if (err != 0) return err;
  *smem = static_cast<long long>(lay.total);
  return 0;
}

extern "C" const char* seq_error_string(int code) {
  if (code == kErrUnsupported) return "unsupported dtype, dimension or potential variant";
  if (code == kErrSharedMemory) return "the pair table does not fit in shared memory";
  if (code == kErrThreads) return "threads per block must be a multiple of 32 in [32, 512]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

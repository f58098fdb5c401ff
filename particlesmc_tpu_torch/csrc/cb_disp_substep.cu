// Checkerboard displacement substep: all `inner` Metropolis sub-moves of one
// colour substep, for every (chain, active cell), in one launch.
//
// Replaces the TPU kernel particlesmc_tpu/moves/cb_pallas.py::build_disp_substep.
// The Python wrapper, its contract and the plain PyTorch version with the same
// arithmetic are in particlesmc_tpu_torch/moves/cb_cuda.py.
//
// Layout (B chains, A active cells, LP = 3^d * cap lanes; centre lanes first):
//   packed_pos [B, D, A, LP]   positions, shifted frame, halos image-corrected
//   packed_sp  [B, A, LP]      species as floats, -1 = empty lane
//   up, thr    [B, inner, A]   pick uniforms; accept thresholds -T log(u)
//   dl         [B, inner, D, A] sigma-scaled Gaussian steps
//   lo, hi     [D, A]          bounds of each active cell (shifted frame)
//   table      [9, S, S]       kind, eps4, sigma2, ipl_n, rcut2, shift, c0, c2s2, c4s4
// Outputs:
//   centre     [B, D, A, cap]  centre-cell positions after the sub-moves
//   booked     [B, A]          sum of the accepted, finite energy changes
//   acc        [B, A, inner]   1 where sub-move k was accepted
//
// Design: one thread block per (chain, cell). The block copies its LP lanes and
// the pair table into shared memory once and keeps them there for all `inner`
// sub-moves, so device memory is read once per launch and the kernel is bound
// by the pair evaluations. Each sub-move: every thread reads the mover, sums
// the energy change over a strided set of lanes, the block reduces it (warp
// shuffles, then shared memory), thread 0 decides and writes the mover's new
// coordinates into its shared lane.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 9;
enum Field { F_KIND, F_EPS4, F_SIGMA2, F_IPL_N, F_RCUT2, F_SHIFT, F_C0, F_C2S2, F_C4S4 };

// models/potentials.py::pair_potential for one pair; `pair` = sa * S + sb,
// `ss` = S * S is the stride between fields of the packed table.
template <typename T>
__device__ __forceinline__ T pair_potential(T r2, const T* tab, int pair, int ss) {
  const int kind = static_cast<int>(tab[F_KIND * ss + pair]);
  if (kind == 0 || !(r2 <= tab[F_RCUT2 * ss + pair])) return T(0);
  const T r2s = r2 > T(1e-12) ? r2 : T(1e-12);
  const T eps4 = tab[F_EPS4 * ss + pair];
  const T x = tab[F_SIGMA2 * ss + pair] / r2s;
  const T x3 = x * x * x;
  if (kind == 2) return eps4 * (x3 * x3 - x3) - tab[F_SHIFT * ss + pair];
  if (kind == 3) {
    const T lj = eps4 * (x3 * x3 - x3);
    return lj + eps4 * (tab[F_C0 * ss + pair] +
                        r2s * (tab[F_C2S2 * ss + pair] + r2s * tab[F_C4S4 * ss + pair]));
  }
  if (kind == 1) {
    // square-and-multiply, as potentials._int_pow
    const int n = static_cast<int>(tab[F_IPL_N * ss + pair]);
    T sq = sqrt(x);
    T acc = T(1);
    for (int k = 0; k < 6; ++k) {
      if ((n >> k) & 1) acc = acc * sq;
      sq = sq * sq;
    }
    return eps4 * acc - tab[F_SHIFT * ss + pair];
  }
  return T(0);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
disp_substep_kernel(const T* __restrict__ packed_pos, const T* __restrict__ packed_sp,
                    const T* __restrict__ up, const T* __restrict__ dl,
                    const T* __restrict__ thr, const T* __restrict__ lo,
                    const T* __restrict__ hi, const T* __restrict__ table, int S, int A,
                    int LP, int cap, int inner, T* __restrict__ centre,
                    T* __restrict__ booked, int* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_pos = reinterpret_cast<T*>(smem_raw);  // [D][LP]
  T* s_sp = s_pos + D * LP;                    // [LP]
  T* s_tab = s_sp + LP;                        // [kFields][S][S]
  __shared__ T s_part[kThreads / 32];
  __shared__ int s_cnt[kThreads / 32];
  __shared__ int s_occ;

  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ss = S * S;

  for (int i = tid; i < LP; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      s_pos[j * LP + i] = packed_pos[((static_cast<size_t>(b) * D + j) * A + a) * LP + i];
    s_sp[i] = packed_sp[(static_cast<size_t>(b) * A + a) * LP + i];
  }
  for (int i = tid; i < kFields * ss; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();

  // occupancy of the centre cell (its first `cap` lanes)
  int cnt = 0;
  for (int i = tid; i < cap; i += blockDim.x) cnt += s_sp[i] >= T(0) ? 1 : 0;
  cnt = warp_sum(cnt);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int w = 0; w < nwarps; ++w) t += s_cnt[w];
    s_occ = t;
  }
  __syncthreads();
  const int occ = s_occ;

  T lo_a[D], hi_a[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    lo_a[j] = lo[j * A + a];
    hi_a[j] = hi[j * A + a];
  }
  T booked_sum = T(0);  // used by thread 0 only

  for (int k = 0; k < inner; ++k) {
    const size_t kb = static_cast<size_t>(b) * inner + k;
    int r = static_cast<int>(floor(up[kb * A + a] * static_cast<T>(occ)));
    r = r < 0 ? 0 : (r >= LP ? LP - 1 : r);  // memory safety only: u < 1 keeps r < occ
    T xa[D], xn[D];
    bool in_cell = occ > 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xa[j] = s_pos[j * LP + r];
      xn[j] = xa[j] + dl[(kb * D + j) * A + a];
      in_cell = in_cell && xn[j] >= lo_a[j] && xn[j] < hi_a[j];
    }
    // an empty cell picks an empty lane (species -1); the move is rejected
    // by in_cell, so any row of the table serves its (unused) energy change
    const int sa = max(0, static_cast<int>(s_sp[r]));

    T part = T(0);
    for (int i = tid; i < LP; i += blockDim.x) {
      const T s = s_sp[i];
      if (s >= T(0) && i != r) {
        T r2o = T(0), r2n = T(0);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const T p = s_pos[j * LP + i];
          const T dxo = p - xa[j];
          const T dxn = p - xn[j];
          r2o = r2o + dxo * dxo;
          r2n = r2n + dxn * dxn;
        }
        const int pair = sa * S + static_cast<int>(s);
        part += pair_potential(r2n, s_tab, pair, ss) - pair_potential(r2o, s_tab, pair, ss);
      }
    }
    part = warp_sum(part);
    if (lane == 0) s_part[warp] = part;
    __syncthreads();
    if (tid == 0) {
      T de = T(0);
      for (int w = 0; w < nwarps; ++w) de += s_part[w];
      const bool accept = (de < thr[kb * A + a]) && in_cell;
      if (accept) {
        if (isfinite(de)) booked_sum += de;
#pragma unroll
        for (int j = 0; j < D; ++j) s_pos[j * LP + r] = xn[j];
      }
      acc[(static_cast<size_t>(b) * A + a) * inner + k] = accept ? 1 : 0;
    }
    __syncthreads();
  }

  for (int i = tid; i < cap; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      centre[((static_cast<size_t>(b) * D + j) * A + a) * cap + i] = s_pos[j * LP + i];
  }
  if (tid == 0) booked[static_cast<size_t>(b) * A + a] = booked_sum;
}

template <typename T, int D>
int launch(const void* packed_pos, const void* packed_sp, const void* up, const void* dl,
           const void* thr, const void* lo, const void* hi, const void* table, int S, int B,
           int A, int LP, int cap, int inner, void* centre, void* booked, void* acc,
           cudaStream_t stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(D + 1) * LP + static_cast<size_t>(kFields) * S * S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        disp_substep_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(A, B);
  disp_substep_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(packed_pos), static_cast<const T*>(packed_sp),
      static_cast<const T*>(up), static_cast<const T*>(dl), static_cast<const T*>(thr),
      static_cast<const T*>(lo), static_cast<const T*>(hi), static_cast<const T*>(table), S, A,
      LP, cap, inner, static_cast<T*>(centre), static_cast<T*>(booked), static_cast<int*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cb_disp_substep(int is_f64, int d, const void* packed_pos, const void* packed_sp,
                               const void* up, const void* dl, const void* thr, const void* lo,
                               const void* hi, const void* table, int S, int B, int A, int LP,
                               int cap, int inner, void* centre, void* booked, void* acc,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64 && d == 2)
    return launch<double, 2>(packed_pos, packed_sp, up, dl, thr, lo, hi, table, S, B, A, LP, cap,
                             inner, centre, booked, acc, st);
  if (is_f64 && d == 3)
    return launch<double, 3>(packed_pos, packed_sp, up, dl, thr, lo, hi, table, S, B, A, LP, cap,
                             inner, centre, booked, acc, st);
  if (!is_f64 && d == 2)
    return launch<float, 2>(packed_pos, packed_sp, up, dl, thr, lo, hi, table, S, B, A, LP, cap,
                            inner, centre, booked, acc, st);
  if (!is_f64 && d == 3)
    return launch<float, 3>(packed_pos, packed_sp, up, dl, thr, lo, hi, table, S, B, A, LP, cap,
                            inner, centre, booked, acc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

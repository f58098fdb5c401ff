// Checkerboard displacement substep: all `inner` Metropolis sub-moves of one
// colour substep, for every (chain, active cell), in one launch.
//
// Replaces the TPU kernel particlesmc_tpu/moves/cb_pallas.py::build_disp_substep.
// The Python wrapper, its contract and the plain PyTorch version with the same
// arithmetic are in particlesmc_tpu_torch/moves/cb_cuda.py.
//
// Layout (B chains, A active cells, LP lanes: cap centre lanes first, then the
// neighbour lanes, 3^d * cap in all or cap + K after candidate compaction):
//   packed_pos [B, D, A, LP]   positions, shifted frame, halos image-corrected
//   packed_sp  [B, A, LP]      species as floats, -1 = empty lane
//   up, thr    [B, inner, A]   pick uniforms in [0, 1); accept thresholds -T log(u)
//   dl         [B, inner, D, A] sigma-scaled Gaussian steps
//   lo, hi     [D, A]          bounds of each active cell (shifted frame)
//   table      [9, S, S]       kind, eps4, sigma2, ipl_n, rcut2, shift, c0, c2s2, c4s4
// Outputs:
//   centre     [B, D, A, cap]  centre-cell positions after the sub-moves
//   booked     [B, A]          sum of the accepted, finite energy changes
//   acc        [B, A, inner]   1 where sub-move k was accepted
//
// What bounds it: instructions, not bytes. Device memory is read once
// per launch; each sub-move is a chain of dependent steps (pick, a sum of
// pair terms over the neighbourhood, a decision, an update of one lane), so
// the time is the instructions issued per sub-move and the latency between
// the steps, which the few warps that fit an SM must hide.
//
// Design: one warp owns one (chain, cell) for the whole inner loop; a block
// holds `cpb` cells (the launcher takes the largest of 4, 2, 1 whose shared
// memory fits). The warp copies its cell into its own slice of shared memory
// once: the centre lanes verbatim (the pick floor(u * occ) stays a lane
// index), the neighbour lanes compacted to the valid ones (ballot + popc, in
// order), species as int8, and its draws for all sub-moves. The inner loop
// then reads no device memory and has no block barrier: every lane sums its
// share of the pair terms, two lanes per iteration; a butterfly of shuffles
// gives every lane the same sum, every lane takes the same decision, lane 0
// books and moves the lane. A pair term is first tested against the largest
// cutoff of the mover's row, so a pass of 32 lanes that are all beyond it
// skips the potential. The potential (pair_terms.cuh) is a template on the
// kinds in the table (one variant per kind, and a generic one for any mix),
// reads the mover's row of the table, and takes sigma2 / r2 as sigma2 times a
// correctly rounded reciprocal.

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kMaxCellsPerBlock = 4;

// Shared memory: the block's table, then one slice per warp (cell).
// Lanes are padded to a multiple of 64 (the lane loop takes two per thread).
struct Plan {
  int lp_pad;       // lanes of a slice
  int tab_bytes;    // table region
  int slice_bytes;  // one warp's slice
  int cpb;          // cells (warps) per block
  size_t smem;      // dynamic shared memory of a block
};

template <typename T, int D>
int make_plan(int S, int LP, int inner, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  p->lp_pad = (LP + 63) / 64 * 64;
  // table: the fields [kFields][S][S], the row maxima of rcut2 [S], then
  // kind and ipl_n [S][S] as ints
  p->tab_bytes = static_cast<int>(round16(sizeof(T) * (kFields * S * S + S) + sizeof(int) * 2 * S * S));
  // per warp: positions [D][lp_pad], up [inner], thr [inner], dl [inner][D],
  // accepts [inner] int, species [lp_pad] int8
  p->slice_bytes = static_cast<int>(round16(
      sizeof(T) * (static_cast<size_t>(D) * p->lp_pad + static_cast<size_t>(inner) * (D + 2)) +
      sizeof(int) * inner + p->lp_pad));
  for (int cpb = kMaxCellsPerBlock; cpb >= 1; cpb /= 2) {
    const size_t smem = p->tab_bytes + static_cast<size_t>(cpb) * p->slice_bytes;
    if (smem <= static_cast<size_t>(optin)) {
      p->cpb = cpb;
      p->smem = smem;
      return 0;
    }
  }
  return kErrSharedMemory;
}

template <typename T, int D, int V>
__global__ void __launch_bounds__(kWarp * kMaxCellsPerBlock)
disp_substep_kernel(const T* __restrict__ packed_pos, const T* __restrict__ packed_sp,
                    const T* __restrict__ up, const T* __restrict__ dl,
                    const T* __restrict__ thr, const T* __restrict__ lo,
                    const T* __restrict__ hi, const T* __restrict__ table, int S, int A,
                    int LP, int cap, int inner, Plan plan, T* __restrict__ centre,
                    T* __restrict__ booked, int* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ss = S * S;
  T* s_tab = reinterpret_cast<T*>(smem_raw);  // [kFields][S][S]
  T* s_rmax = s_tab + kFields * ss;            // [S] largest rcut2 of each row
  int* s_kind = reinterpret_cast<int*>(s_rmax + S);  // [S][S]
  int* s_ipl_n = s_kind + ss;                        // [S][S]
  for (int i = threadIdx.x; i < kFields * ss; i += blockDim.x) s_tab[i] = table[i];
  for (int i = threadIdx.x; i < ss; i += blockDim.x) {
    s_kind[i] = static_cast<int>(table[F_KIND * ss + i]);
    s_ipl_n[i] = static_cast<int>(table[F_IPL_N * ss + i]);
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    T m = table[F_RCUT2 * ss + i * S];
    for (int j = 1; j < S; ++j) m = max(m, table[F_RCUT2 * ss + i * S + j]);
    s_rmax[i] = m;
  }
  __syncthreads();  // the only block barrier; warps of the ragged edge leave after it

  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int a = blockIdx.x * plan.cpb + warp;
  if (a >= A) return;
  const int b = blockIdx.y;
  const int lp = plan.lp_pad;
  unsigned char* slice = smem_raw + plan.tab_bytes + static_cast<size_t>(warp) * plan.slice_bytes;
  T* s_pos = reinterpret_cast<T*>(slice);  // [D][lp]
  T* s_up = s_pos + D * lp;                // [inner]
  T* s_thr = s_up + inner;                 // [inner]
  T* s_dl = s_thr + inner;                 // [inner][D]
  int* s_acc = reinterpret_cast<int*>(s_dl + inner * D);         // [inner]
  signed char* s_sp = reinterpret_cast<signed char*>(s_acc + inner);  // [lp]

  const size_t cell = static_cast<size_t>(b) * A + a;
  const T* g_sp = packed_sp + cell * LP;
  const T* g_pos[D];
#pragma unroll
  for (int j = 0; j < D; ++j) g_pos[j] = packed_pos + ((static_cast<size_t>(b) * D + j) * A + a) * LP;

  // centre lanes verbatim; occ counts the valid ones
  int occ = 0;
  for (int i0 = 0; i0 < cap; i0 += kWarp) {
    const int i = i0 + lane;
    const T s = i < cap ? g_sp[i] : T(-1);
    occ += __popc(__ballot_sync(kFull, s >= T(0)));
    if (i < cap) {
      s_sp[i] = s >= T(0) ? static_cast<signed char>(s) : static_cast<signed char>(-1);
#pragma unroll
      for (int j = 0; j < D; ++j) s_pos[j * lp + i] = g_pos[j][i];
    }
  }
  // neighbour lanes compacted to the valid ones, in order
  int n = cap;
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = cap; i0 < LP; i0 += kWarp) {
    const int i = i0 + lane;
    const T s = i < LP ? g_sp[i] : T(-1);
    const unsigned m = __ballot_sync(kFull, s >= T(0));
    if (s >= T(0)) {
      const int dst = n + __popc(m & below);
      s_sp[dst] = static_cast<signed char>(s);
#pragma unroll
      for (int j = 0; j < D; ++j) s_pos[j * lp + dst] = g_pos[j][i];
    }
    n += __popc(m);
  }
  const int n_pad = (n + 63) / 64 * 64;
  for (int i = n + lane; i < n_pad; i += kWarp) s_sp[i] = -1;
  // the cell's draws for all sub-moves
  for (int k = lane; k < inner; k += kWarp) {
    const size_t kb = static_cast<size_t>(b) * inner + k;
    s_up[k] = up[kb * A + a];
    s_thr[k] = thr[kb * A + a];
#pragma unroll
    for (int j = 0; j < D; ++j) s_dl[k * D + j] = dl[(kb * D + j) * A + a];
  }
  T lo_a[D], hi_a[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    lo_a[j] = lo[j * A + a];
    hi_a[j] = hi[j * A + a];
  }
  __syncwarp();

  T booked_sum = T(0);  // lane 0's
  for (int k = 0; k < inner; ++k) {
    int r = static_cast<int>(floor(s_up[k] * static_cast<T>(occ)));
    r = r < 0 ? 0 : (r >= cap ? cap - 1 : r);  // memory safety only: u < 1 keeps r < occ
    T xa[D], xn[D];
    bool in_cell = occ > 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xa[j] = s_pos[j * lp + r];
      xn[j] = xa[j] + s_dl[k * D + j];
      in_cell = in_cell && xn[j] >= lo_a[j] && xn[j] < hi_a[j];
    }
    bool accept = false;
    T de = T(0);
    if (in_cell) {  // the same in every lane; a rejected proposal needs no ΔE
      const int sa = max(0, static_cast<int>(s_sp[r]));
      const int off = sa * S;
      const Row<T> row{s_tab + F_EPS4 * ss + off, s_tab + F_SIGMA2 * ss + off,
                       s_tab + F_RCUT2 * ss + off, s_tab + F_SHIFT * ss + off,
                       s_tab + F_C0 * ss + off,    s_tab + F_C2S2 * ss + off,
                       s_tab + F_C4S4 * ss + off,  s_kind + off,
                       s_ipl_n + off};
      const T rmax = s_rmax[sa];
      T part = T(0);
      for (int i0 = 0; i0 < n; i0 += 2 * kWarp) {
        int sb[2];
        T p[2][D];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u * kWarp + lane;
          sb[u] = s_sp[i];
#pragma unroll
          for (int j = 0; j < D; ++j) p[u][j] = s_pos[j * lp + i];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u * kWarp + lane;
          T r2o = T(0), r2n = T(0);
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const T dxo = p[u][j] - xa[j];
            const T dxn = p[u][j] - xn[j];
            r2o = r2o + dxo * dxo;
            r2n = r2n + dxn * dxn;
          }
          // beyond the row's largest cutoff both terms are 0: skip the rest
          if (sb[u] >= 0 && i != r && (r2o <= rmax || r2n <= rmax)) {
            const T rc = row.rcut2[sb[u]];
            const PairParams<T> q = load_pair<T, V>(row, sb[u]);
            const T un = r2n <= rc ? potential<T, V, Q_RECIPROCAL>(r2n, q) : T(0);
            const T uo = r2o <= rc ? potential<T, V, Q_RECIPROCAL>(r2o, q) : T(0);
            part += un - uo;
          }
        }
      }
      de = warp_allsum(part);
      accept = de < s_thr[k];
    }
    if (lane == 0) {
      if (accept) {
        if (isfinite(de)) booked_sum += de;
#pragma unroll
        for (int j = 0; j < D; ++j) s_pos[j * lp + r] = xn[j];
      }
      s_acc[k] = accept ? 1 : 0;
    }
    __syncwarp();
  }

  for (int i = lane; i < cap; i += kWarp) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      centre[((static_cast<size_t>(b) * D + j) * A + a) * cap + i] = s_pos[j * lp + i];
  }
  for (int k = lane; k < inner; k += kWarp) acc[cell * inner + k] = s_acc[k];
  if (lane == 0) booked[cell] = booked_sum;
}

template <typename T, int D, int V>
int launch(const void* packed_pos, const void* packed_sp, const void* up, const void* dl,
           const void* thr, const void* lo, const void* hi, const void* table, int S, int B,
           int A, int LP, int cap, int inner, void* centre, void* booked, void* acc,
           cudaStream_t stream) {
  Plan plan;
  const int err = make_plan<T, D>(S, LP, inner, &plan);
  if (err != 0) return err;
  if (plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        disp_substep_kernel<T, D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((A + plan.cpb - 1) / plan.cpb, B);
  disp_substep_kernel<T, D, V><<<grid, kWarp * plan.cpb, plan.smem, stream>>>(
      static_cast<const T*>(packed_pos), static_cast<const T*>(packed_sp),
      static_cast<const T*>(up), static_cast<const T*>(dl), static_cast<const T*>(thr),
      static_cast<const T*>(lo), static_cast<const T*>(hi), static_cast<const T*>(table), S, A,
      LP, cap, inner, plan, static_cast<T*>(centre), static_cast<T*>(booked), static_cast<int*>(acc));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int plan_for(int d, int S, int LP, int inner, Plan* p) {
  if (d == 2) return make_plan<T, 2>(S, LP, inner, p);
  if (d == 3) return make_plan<T, 3>(S, LP, inner, p);
  return kErrUnsupported;
}

#define CB_LAUNCH_ARGS                                                                     \
  packed_pos, packed_sp, up, dl, thr, lo, hi, table, S, B, A, LP, cap, inner, centre, booked, \
      acc, stream

template <typename T, int D>
int launch_variant(int variant, const void* packed_pos, const void* packed_sp, const void* up,
                   const void* dl, const void* thr, const void* lo, const void* hi,
                   const void* table, int S, int B, int A, int LP, int cap, int inner,
                   void* centre, void* booked, void* acc, cudaStream_t stream) {
  switch (variant) {
    case V_GENERIC: return launch<T, D, V_GENERIC>(CB_LAUNCH_ARGS);
    case V_INVERSE_POWER: return launch<T, D, V_INVERSE_POWER>(CB_LAUNCH_ARGS);
    case V_LENNARD_JONES: return launch<T, D, V_LENNARD_JONES>(CB_LAUNCH_ARGS);
    case V_SMOOTH_LJ: return launch<T, D, V_SMOOTH_LJ>(CB_LAUNCH_ARGS);
    default: return kErrUnsupported;
  }
}

}  // namespace

// `variant`: 0 for any mix of kinds, else the one kind of the table
// (1 inverse power, 2 Lennard-Jones, 3 smooth LJ).
extern "C" int cb_disp_substep(int is_f64, int d, const void* packed_pos, const void* packed_sp,
                               const void* up, const void* dl, const void* thr, const void* lo,
                               const void* hi, const void* table, int S, int B, int A, int LP,
                               int cap, int inner, int variant, void* centre, void* booked,
                               void* acc, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f64 && d == 2) return launch_variant<double, 2>(variant, CB_LAUNCH_ARGS);
  if (is_f64 && d == 3) return launch_variant<double, 3>(variant, CB_LAUNCH_ARGS);
  if (!is_f64 && d == 2) return launch_variant<float, 2>(variant, CB_LAUNCH_ARGS);
  if (!is_f64 && d == 3) return launch_variant<float, 3>(variant, CB_LAUNCH_ARGS);
  return kErrUnsupported;
}

// The launcher's choice for these shapes: cells per block and dynamic shared
// memory bytes of a block.
extern "C" int cb_disp_substep_plan(int is_f64, int d, int S, int LP, int inner, int* cpb,
                                    long long* smem) {
  Plan p;
  const int err = is_f64 ? plan_for<double>(d, S, LP, inner, &p) : plan_for<float>(d, S, LP, inner, &p);
  if (err != 0) return err;
  *cpb = p.cpb;
  *smem = static_cast<long long>(p.smem);
  return 0;
}

extern "C" const char* cb_error_string(int code) {
  if (code == kErrUnsupported) return "unsupported dtype, dimension or potential variant";
  if (code == kErrSharedMemory) return "the cell's lanes do not fit in shared memory even at one cell per block";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

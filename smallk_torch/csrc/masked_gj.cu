// Masked Gauss-Jordan solve for the BPP NNLS inner loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel smallk_tpu/solvers/pallas_kernels.py:_gj_kernel
// (called through masked_gj_solve_pallas).  For every column j, with
// p = passive[:, j]:
//
//     ((p p^T) .* LHS + diag(1 - p)) x = p .* rhs_j
//
// by unpivoted Gauss-Jordan, with the dead-pivot guard: a pivot with
// |piv| <= k * eps * (max|LHS| + 1) turns its row into a unit row whose
// solution component is 0.  Non-passive rows come out 0.
//
// Two device kernels compute it, and the wrapper picks one by k
// (kernels/masked_gj.py: WIDE_MIN_K).  Both keep the arithmetic of the
// plain torch version (kernels/masked_gj.py:masked_gj_solve_reference) op
// for op: every product, difference and quotient is an _rn intrinsic, so
// nothing is contracted into a fused multiply-add and nothing is
// reordered, and on finite inputs both equal the plain version with max
// abs difference 0 (a zero's sign may differ).  An unfused multiply and
// subtract are two instructions per element update, so the ceiling of this
// arithmetic is half the card's 67 TFLOP/s of f32 (which counts a fused
// multiply-add as two operations in one instruction).
//
// masked_gj_kernel, for narrow ranks.  At the k = 8 of the Reuters-shape
// path the solve is O(k^2) bytes per column against O(k^3) flops and is
// bound by the latency of the k-step dependency chain (k pivot steps,
// each a divide and a broadcast), about 10 us a launch.
//   - A CTA takes `cols` columns (a power of two <= 32, as many as fit two
//     CTAs per SM) and holds each column's full masked (k, k+1) system in
//     shared memory, laid out [row][col][column-in-CTA] so that the threads
//     of a warp, which own neighbouring columns, hit neighbouring banks.
//   - threadIdx.x is the column, threadIdx.y a row group: a thread owns rows
//     ty, ty + R, ...  RHS, passive and X are (k, n) row-major, so column j
//     is strided by n and neighbouring threads read neighbouring columns.
//   - LHS is staged in shared memory once per CTA when it fits beside the
//     systems, and tiny is reduced per CTA on the device: no host sync.
//   - At k = 128 one column's system is 66 KB, so a CTA holds one column,
//     an SM one CTA of four warps, and each thread runs a dependent chain
//     of shared load, multiply, subtract, shared store behind three
//     __syncthreads() per pivot step, on a system of which (with half the
//     entries passive) 7 of 8 updates are x - 0 * y.  That is what the
//     second kernel is for.
//
// masked_gj_wide_kernel, for wide ranks.  What bounds it: with q passive
// rows a column needs ~q^3 / 2 element updates on a q x (q+1) system that
// only shared memory can hold.  Taken one pivot step at a time, each update
// is a shared load and a shared store, and the SM's shared-memory pipe (one
// warp-wide access per clock) sets the pace; with the steps blocked as
// below, the rate at which an SM's schedulers hand out the unfused
// multiplies and subtracts does.
//   - Compact per column: a ballot and prefix over passive[:, j] gives the
//     column's passive index list; the q x q block of LHS and the q
//     right-hand sides are gathered into a q x (q+1) system (row stride
//     q + 1 rounded up to 4); the Gauss-Jordan runs on that; x is scattered
//     to the passive rows and 0 written to the others.  The rows and
//     columns this leaves out are the ones on which the full masked system
//     multiplies by zero: a non-passive pivot row is a unit row whose
//     factors are all 0, so the compact solve is the full one, rounding
//     for rounding.  tiny keeps the full k and the full LHS.
//   - One warp per column, lanes across a row's elements (consecutive
//     banks), one __syncwarp() where the narrow kernel has a
//     __syncthreads().
//   - Four pivot steps (two in f64) per pass over the rows (wide_steps):
//     the four pivot rows are eliminated among themselves in registers,
//     then every other row is loaded once, takes the four steps in
//     registers in the order and with the roundings of four single steps
//     (its four factors come in one 16-byte broadcast load), and is stored
//     once.  8 rows are in flight per lane, the code of a pass is
//     specialised on the number of 32-lane segments and has no branch, and
//     no row is singled out (the pivot rows ride along with zero factors).
//   - A persistent grid: a CTA per SM of up to 16 warps, each CTA walking
//     its columns in batches.  The slots come from one pool of shared
//     memory and are sized by each column's own q, so 3 columns are
//     resident per SM at q = 128 and 11 at q = 64 (f32, k = 128); where a
//     full slot per warp fits (small k) no warp waits for another.  LHS is
//     staged in shared memory when that costs an eighth of the room at
//     most (else read through L1/L2), and tiny is reduced once per CTA, not
//     once per column.  Neighbouring CTAs take neighbouring columns, so a
//     few columns spread over as many SMs.
//   - Non-finite inputs.  In the plain version an Inf or NaN in rhs on a
//     non-passive row becomes NaN (rhs * 0) and poisons its whole column,
//     which a compact solve would drop.  So a column whose rhs holds any
//     non-finite value comes out all NaN (where tiny >= 1 the plain
//     version turns that row into a dead pivot and stays finite: the kernel
//     is the stricter of the two, and the caller's gradient LHS X - RHS is
//     non-finite either way).  A non-finite LHS makes tiny Inf or NaN,
//     every pivot dead and X all zeros, in both.
//   - wgmma takes no f32 operand and TF32 keeps ~3 digits, which breaks
//     the NNLS sign tests: no tensor cores here.  Several warps on one
//     column where q is near 128 gained little on an all-passive round
//     and were not kept.  What is left is instruction overhead (the idle
//     lanes of a row's last segment, the factors' updates that every lane
//     repeats); a register-resident system is later work.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;     // 227 KB: the most a block may opt into
constexpr size_t kTargetSmem = 96 * 1024;  // leaves room for two CTAs per SM
// the wide kernel
constexpr int kWideMaxWarps = 16;      // columns in flight per CTA
constexpr int kWideRowBytes = 32;      // rows in flight per lane: 8 of f32
constexpr int kWideBlockBytes = 16;    // pivot steps per block: 4 of f32
constexpr int kWideGather = 4;         // rows of LHS in flight in the gather
constexpr int kWideSegs = kMaxK / 32;  // 32-lane segments of a row

template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
};

template <> struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
};

// max that propagates NaN, as torch.max and jnp.max do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b <= a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
masked_gj_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                 const uint8_t* __restrict__ passive, T* __restrict__ x,
                 int k, int n, int lhs_in_smem) {
  using O = Ops<T>;
  const int cols = blockDim.x;
  const int R = blockDim.y;
  const int c = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * cols + c;
  const int nthreads = cols * R;  // a multiple of 32 (see launch)
  const long long col = (long long)blockIdx.x * cols + c;
  const bool valid = col < n;
  const int w1 = k + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  T* aug = reinterpret_cast<T*>(smem);                    // [k][k+1][cols]
  T* s_lhs = aug + (size_t)k * w1 * cols;                 // [k][k] if staged
  T* s_red = s_lhs + (lhs_in_smem ? k * k : 0);           // [32] + tiny
  uint8_t* s_p = reinterpret_cast<uint8_t*>(s_red + 33);  // [k][cols]
#define AUG(r, l) aug[((r) * w1 + (l)) * cols + c]

  if (lhs_in_smem) {
    for (int i = tid; i < k * k; i += nthreads) s_lhs[i] = lhs[i];
  }
  const T* L = lhs_in_smem ? s_lhs : lhs;
  for (int l = ty; l < k; l += R) {
    s_p[l * cols + c] = valid ? passive[(size_t)l * n + col] : 0;
  }
  __syncthreads();

  // tiny = k * eps * (max|LHS| + 1), reduced on the device
  T m = T(0);
  for (int i = tid; i < k * k; i += nthreads) m = nan_max(m, O::abs(L[i]));
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = m;

  // masked system: M[r][l] = LHS[r][l] * (p_r p_l) + I[r][l] * (1 - p_r),
  // b[r] = rhs[r] * p_r (a multiply, not a select: Inf * 0 gives NaN as in
  // the reference, and the caller's finiteness gate sees it)
  for (int r = ty; r < k; r += R) {
    const T p_r = T(s_p[r * cols + c]);
    const T omp = O::sub(T(1), p_r);
    for (int l = 0; l < k; ++l) {
      const T p_l = T(s_p[l * cols + c]);
      const T v = O::mul(L[r * k + l], O::mul(p_r, p_l));
      AUG(r, l) = O::add(v, O::mul(r == l ? T(1) : T(0), omp));
    }
    const T b = valid ? rhs[(size_t)r * n + col] : T(0);
    AUG(r, k) = O::mul(b, p_r);
  }
  __syncthreads();
  if (tid == 0) {
    T mm = s_red[0];
    for (int w = 1; w < nthreads / 32; ++w) mm = nan_max(mm, s_red[w]);
    s_red[32] = O::mul(O::mul(T(k), O::eps()), O::add(mm, T(1)));
  }
  __syncthreads();
  const T tiny = s_red[32];

  // Gauss-Jordan.  Columns < j of the pivot row are never read again, so
  // each step touches columns j..k only.
  for (int j = 0; j < k; ++j) {
    const T piv = AUG(j, j);
    const bool safe = O::abs(piv) > tiny;
    __syncthreads();  // every thread has its pivot before row j changes
    for (int l = j + ty; l <= k; l += R) {
      AUG(j, l) = safe ? O::div(AUG(j, l), piv) : (l == j ? T(1) : T(0));
    }
    __syncthreads();
    if (safe) {  // a dead pivot eliminates nothing
      for (int r = ty; r < k; r += R) {
        if (r == j) continue;
        const T f = AUG(r, j);
        for (int l = j + 1; l <= k; ++l) {
          AUG(r, l) = O::sub(AUG(r, l), O::mul(f, AUG(j, l)));
        }
      }
    }
    __syncthreads();
  }

  if (valid) {
    for (int r = ty; r < k; r += R) x[(size_t)r * n + col] = AUG(r, k);
  }
#undef AUG
}

template <typename T>
int launch(const void* lhs, const void* rhs, const void* passive, void* x,
           int k, int n, void* stream, int device) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  const size_t per_col = (size_t)k * (k + 1) * sizeof(T);
  const size_t lhs_bytes = (size_t)k * k * sizeof(T);
  auto smem_bytes = [&](int cols, bool stage_lhs) {
    return cols * per_col + (stage_lhs ? lhs_bytes : 0) + 33 * sizeof(T) +
           (size_t)k * cols;
  };
  int cols = 32;
  while (cols > 1 && smem_bytes(cols, true) > kTargetSmem) cols >>= 1;
  const bool stage_lhs = smem_bytes(cols, true) <= kMaxSmem;
  const size_t smem = smem_bytes(cols, stage_lhs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;

  // rows per column group: up to kMaxThreads threads in all, rounded up so
  // that the block is whole warps (the tiny reduction shuffles full warps)
  int R = k < kMaxThreads / cols ? k : kMaxThreads / cols;
  const int warp_rows = 32 / cols;
  R = (R + warp_rows - 1) / warp_rows * warp_rows;

  // per device, so set on every launch that needs it (it is cheap)
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(masked_gj_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(cols, R);
  const dim3 grid((unsigned)((n + cols - 1) / cols));
  masked_gj_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)lhs, (const T*)rhs, (const uint8_t*)passive, (T*)x, k, n,
      stage_lhs ? 1 : 0);
  return (int)cudaGetLastError();
}


// tiny = k * eps * (max|LHS| + 1), reduced by the whole CTA (whole warps)
// into red[32]; red holds 33 values
template <typename T>
__device__ __forceinline__ T cta_tiny(const T* __restrict__ lhs, int k,
                                      int tid, int nthreads, T* red) {
  using O = Ops<T>;
  T m = T(0);
  for (int i = tid; i < k * k; i += nthreads) m = nan_max(m, O::abs(lhs[i]));
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    T mm = red[0];
    for (int w = 1; w < nthreads / 32; ++w) mm = nan_max(mm, red[w]);
    red[32] = O::mul(O::mul(T(k), O::eps()), O::add(mm, T(1)));
  }
  __syncthreads();
  return red[32];
}

// The row stride of a column's q x (q+1) system: rows stay 16-byte aligned.
__host__ __device__ constexpr int wide_stride(int q) {
  return (q + 1 + 3) & ~3;
}

// Elements of the slot of a column with q passive rows: its system, the
// rows that the last batch of rows overhangs, and the 128 elements that
// the last segment's idle lanes read behind the last row (a multiple of 4
// elements, so that slots stay 16-byte aligned).

template <typename T>
__host__ __device__ constexpr int wide_slot(int q) {
  return (q + kWideRowBytes / (int)sizeof(T)) * wide_stride(q) + 128;
}

// The factors of a row for a block of B pivot steps: its B elements from
// column j on, in one load where the type and the alignment allow (j and
// the row stride are multiples of 4).
template <typename T, int B>
struct WideHead {
  static __device__ __forceinline__ void load(const T* p, T (&g)[B]) {
#pragma unroll
    for (int t = 0; t < B; ++t) g[t] = p[t];
  }
};

template <>
struct WideHead<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&g)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  }
};

template <>
struct WideHead<double, 2> {
  static __device__ __forceinline__ void load(const double* p,
                                              double (&g)[2]) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    g[0] = v.x; g[1] = v.y;
  }
};

// One pass of a block of B pivot steps over all rows of S: a row's factor
// for step i is its head element i after the steps before i.  Straight
// code without a branch when every pivot of the block is safe (ALL).
template <typename T, int B, int U, int NS, bool ALL>
__device__ __forceinline__ void wide_pass(
    T* S, int st, int q, int j, int lane, const bool (&act)[NS],
    const bool (&safe)[B], const T (&P)[B][NS], const T (&C)[B][B]) {
  using O = Ops<T>;
  const T* head = S + j;
  T* e = S + j + B + lane;  // row 0, this lane's first element
  for (int r0 = 0; r0 < q; r0 += U) {
    T g[U][B];
    T a[NS][U];
#pragma unroll
    for (int u = 0; u < U; ++u) WideHead<T, B>::load(head + u * st, g[u]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) a[s][u] = e[u * st + 32 * s];
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (ALL || safe[i]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T f = g[u][i];
#pragma unroll
          for (int t = i + 1; t < B; ++t) {
            g[u][t] = O::sub(g[u][t], O::mul(f, C[i][t]));
          }
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            a[s][u] = O::sub(a[s][u], O::mul(f, P[i][s]));
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (act[s]) e[u * st + 32 * s] = a[s][u];
      }
    }
    head += U * st;
    e += U * st;
  }
}

// B pivot steps j .. j+B-1 of the Gauss-Jordan on the q x (q+1) system S
// (row stride st), by one warp, in the order and with the roundings of B
// single steps.  What the block saves is shared-memory traffic: a row's
// elements are loaded and stored once for B steps, not B times.
//
// A lane owns the columns j+B + lane + 32 s, s < NS (those beyond the
// block; NS segments cover them).  The block's own B x B head, which holds
// every factor, is carried as uniform scalars.  First the B pivot rows are
// eliminated among themselves in registers: P[i] is pivot row j+i as
// normalised at its own step (what the other rows subtract), C[i][t] the
// same row's head, R[i] the row as the later steps of the block leave it.
// Then every other row takes the B steps in registers (wide_pass), U rows
// in flight.  R goes back to shared memory with a zeroed head, so that the
// pivot rows ride along in the pass unchanged (a - 0 * p) and no row is
// singled out; a batch that overhangs the last row works on the slot's
// padding rows; an idle lane of the last segment loads what lies behind
// the row's end and stores nothing.  A dead pivot leaves a unit row and
// eliminates nothing.
template <typename T, int B, int NS>
__device__ __forceinline__ void wide_steps(T* S, int st, int q, int j, T tiny,
                                           int lane) {
  using O = Ops<T>;
  // rows in flight: fewer where a row's segments fill the registers
  constexpr int U = (NS <= 2 ? kWideRowBytes : kWideRowBytes / 2) /
                    (int)sizeof(T);
  const int cnt = q + 1 - (j + B);  // columns beyond the block: >= 1
  bool act[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) act[s] = lane + 32 * s < cnt;

  T R[B][NS], P[B][NS], H[B][B], C[B][B];
  bool safe[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    WideHead<T, B>::load(S + (j + i) * st + j, H[i]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      R[i][s] = S[(j + i) * st + j + B + lane + 32 * s];
    }
  }
  bool any_safe = false, all_safe = true;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const T piv = H[i][i];
    safe[i] = O::abs(piv) > tiny;
    any_safe |= safe[i];
    all_safe &= safe[i];
#pragma unroll
    for (int t = 0; t < B; ++t) {
      C[i][t] = T(0);
      if (t > i) {
        H[i][t] = safe[i] ? O::div(H[i][t], piv) : T(0);
        C[i][t] = H[i][t];
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      R[i][s] = safe[i] ? O::div(R[i][s], piv) : T(0);
      P[i][s] = R[i][s];
    }
    if (safe[i]) {
#pragma unroll
      for (int i2 = 0; i2 < B; ++i2) {
        if (i2 != i) {
          const T f = H[i2][i];
#pragma unroll
          for (int t = i + 1; t < B; ++t) {
            H[i2][t] = O::sub(H[i2][t], O::mul(f, C[i][t]));
          }
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            R[i2][s] = O::sub(R[i2][s], O::mul(f, P[i][s]));
          }
        }
      }
    }
  }
  __syncwarp();  // every lane has read the block's rows
#pragma unroll
  for (int i = 0; i < B; ++i) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (act[s]) S[(j + i) * st + j + B + lane + 32 * s] = R[i][s];
    }
  }
  if (lane < B * B) S[(j + lane / B) * st + j + lane % B] = T(0);
  __syncwarp();
  if (all_safe) {
    wide_pass<T, B, U, NS, true>(S, st, q, j, lane, act, safe, P, C);
  } else if (any_safe) {
    wide_pass<T, B, U, NS, false>(S, st, q, j, lane, act, safe, P, C);
  }
  __syncwarp();  // the next steps read what other lanes wrote
}

// The same, with the number of 32-lane segments that the columns beyond
// the block need picked at run time (it is uniform over the warp).
template <typename T, int B>
__device__ __forceinline__ void wide_steps_any(T* S, int st, int q, int j,
                                               T tiny, int lane) {
  switch ((q + 1 - (j + B) + 31) >> 5) {
    case 1: wide_steps<T, B, 1>(S, st, q, j, tiny, lane); break;
    case 2: wide_steps<T, B, 2>(S, st, q, j, tiny, lane); break;
    case 3: wide_steps<T, B, 3>(S, st, q, j, tiny, lane); break;
    default: wide_steps<T, B, 4>(S, st, q, j, tiny, lane); break;
  }
}

// The CTA's slots come from one pool of shared memory, so that as many
// columns are resident as their own q allows (3 at q = 128 in f32, 11 at
// q = 64).  The CTA walks its columns in batches: every warp finds the q
// of its candidate column, the slot sizes are summed in warp order, and
// the warps whose slots fit take their columns while the others wait at
// the batch's barrier and offer the same columns again.
struct WidePool {
  int need[kWideMaxWarps];  // slot elements, -1 for no column
};

template <typename T>
__global__ void __launch_bounds__(kWideMaxWarps * 32, 1)
masked_gj_wide_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      const uint8_t* __restrict__ passive, T* __restrict__ x,
                      int k, int n, int lhs_in_smem, int capacity) {
  using O = Ops<T>;
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kBlock = kWideBlockBytes / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_red = reinterpret_cast<T*>(smem);                    // [32] + tiny
  T* s_pool = s_red + 36;                                   // [capacity]
  uint8_t* idx = reinterpret_cast<uint8_t*>(s_pool + capacity) + warp * kMaxK;
  volatile WidePool* pool = reinterpret_cast<WidePool*>(
      reinterpret_cast<uint8_t*>(s_pool + capacity) + warps * kMaxK);
  T* s_lhs = reinterpret_cast<T*>(                          // [k][k] if staged
      reinterpret_cast<uint8_t*>(s_pool + capacity) + warps * kMaxK +
      sizeof(WidePool));

  if (lhs_in_smem) {
    for (int i = tid; i < k * k; i += blockDim.x) s_lhs[i] = lhs[i];
  }
  const T tiny = cta_tiny(lhs, k, tid, blockDim.x, s_red);  // syncs the CTA
  const T* L = lhs_in_smem ? s_lhs : lhs;

  // neighbouring CTAs take neighbouring columns: this CTA's are
  // blockIdx.x + gridDim.x * i for i < mine
  const int mine = (n - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // with room for a full slot per warp no warp ever waits for another
  const bool roomy = capacity >= warps * wide_slot<T>(k);
  int base = 0;
  while (base < mine) {  // one batch; uniform over the CTA
    const bool have = base + warp < mine;
    const long long col = blockIdx.x + (long long)gridDim.x * (base + warp);
    // the passive index list (ballot and prefix), the column's rhs, and
    // whether any of it is not finite
    int q = 0;
    int pos[kWideSegs];
    bool pb[kWideSegs];
    T rv[kWideSegs];
    bool poisoned = false;
#pragma unroll
    for (int s = 0; s < kWideSegs; ++s) {
      const int l = lane + 32 * s;
      const bool in = have && l < k;
      pb[s] = in && passive[(size_t)l * n + col] != 0;
      rv[s] = in ? rhs[(size_t)l * n + col] : T(0);
      poisoned |= !(O::abs(rv[s]) <= O::max());
      const unsigned mask = __ballot_sync(kFull, pb[s]);
      pos[s] = q + __popc(mask & ((1u << lane) - 1u));
      if (pb[s]) idx[pos[s]] = (uint8_t)l;
      q += __popc(mask);
    }
    poisoned = __any_sync(kFull, poisoned);
    int at = warp * wide_slot<T>(k), take = warps;
    bool taken = have;
    if (!roomy) {
      if (lane == 0) {  // a poisoned column needs no slot
        pool->need[warp] = !have ? -1 : poisoned ? 0 : wide_slot<T>(q);
      }
      __syncthreads();
      // the batch takes the warps up to the first whose slot does not fit
      // behind the slots of the warps before it (warp 0's always fits)
      int end = 0;
      take = 0;
      taken = false;
      for (int w = 0; w < warps; ++w) {
        const int need = pool->need[w];
        if (need < 0 || end + need > capacity) break;
        if (w == warp) {
          at = end;
          taken = true;
        }
        end += need;
        ++take;
      }
    } else {
      __syncwarp();  // the index list is written
    }
    base += take;
    if (taken && poisoned) {
      const T nan = T(NAN);
#pragma unroll
      for (int s = 0; s < kWideSegs; ++s) {
        const int l = lane + 32 * s;
        if (l < k) x[(size_t)l * n + col] = nan;
      }
    }
    if (taken && !poisoned) {
      const int st = wide_stride(q);
      T* S = s_pool + at;  // this column's slot
      int ib[kWideSegs];
#pragma unroll
      for (int s = 0; s < kWideSegs; ++s) {
        const int b = lane + 32 * s;
        ib[s] = b < q ? idx[b] : 0;
      }
      for (int a0 = 0; a0 < q; a0 += kWideGather) {
        T g[kWideGather][kWideSegs];
        int ar[kWideGather];
#pragma unroll
        for (int u = 0; u < kWideGather; ++u) {
          ar[u] = a0 + u < q ? a0 + u : q - 1;  // a repeated row stores twice
          const T* Lrow = L + (int)idx[ar[u]] * k;
#pragma unroll
          for (int s = 0; s < kWideSegs; ++s) {
            if (32 * s < q) g[u][s] = Lrow[ib[s]];
          }
        }
#pragma unroll
        for (int u = 0; u < kWideGather; ++u) {
#pragma unroll
          for (int s = 0; s < kWideSegs; ++s) {
            const int b = lane + 32 * s;
            if (b < q) S[ar[u] * st + b] = O::add(g[u][s], T(0));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kWideSegs; ++s) {
        if (pb[s]) S[pos[s] * st + q] = rv[s];
      }
      __syncwarp();

      // Gauss-Jordan on the compact system, kWideBlock pivot steps at a
      // time, then the steps that are left one by one
      int j = 0;
      for (; j + kBlock <= q; j += kBlock) {
        wide_steps_any<T, kBlock>(S, st, q, j, tiny, lane);
      }
      for (; j < q; ++j) wide_steps_any<T, 1>(S, st, q, j, tiny, lane);

#pragma unroll
      for (int s = 0; s < kWideSegs; ++s) {
        const int l = lane + 32 * s;
        if (l < k) x[(size_t)l * n + col] = pb[s] ? S[pos[s] * st + q] : T(0);
      }
    }
    if (!roomy) __syncthreads();  // the batch's slots and `need` are free
    else __syncwarp();            // the slot and the index list are free
  }
}

template <typename T>
int launch_wide(const void* lhs, const void* rhs, const void* passive,
                void* x, int k, int n, void* stream, int device) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  // LHS (staged when that costs an eighth of the room at most), the
  // reduction's scratch, the pool of slots, kMaxK index bytes per warp and
  // the pool's table; the pool never needs more than a full slot per warp
  const size_t fixed = 36 * sizeof(T) + sizeof(WidePool);
  const size_t lhs_bytes = (size_t)k * k * sizeof(T);
  const size_t slot_bytes = (size_t)wide_slot<T>(k) * sizeof(T);
  int warps = kWideMaxWarps;
  auto room = [&](int w) { return kMaxSmem - fixed - (size_t)w * kMaxK; };
  const bool stage_lhs = lhs_bytes * 8 <= room(warps);
  auto pool_bytes = [&](int w) {
    const size_t avail = room(w) - (stage_lhs ? lhs_bytes : 0);
    const size_t want = (size_t)w * slot_bytes;
    return (want < avail ? want : avail) & ~(size_t)15;
  };
  auto smem_bytes = [&](int w) {
    return fixed + (stage_lhs ? lhs_bytes : 0) + pool_bytes(w) +
           (size_t)w * kMaxK;
  };
  if (pool_bytes(warps) < slot_bytes) return (int)cudaErrorInvalidValue;

  // per device, so set on every launch (it is cheap)
  err = cudaFuncSetAttribute(masked_gj_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, masked_gj_wide_kernel<T>, warps * 32, smem_bytes(warps));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  // a persistent grid; with few columns, a CTA each and no idle warps
  const long long resident = (long long)sms * per_sm;
  const int grid = n < resident ? n : (int)resident;
  const int needed = (n + grid - 1) / grid;
  if (needed < warps) warps = needed;
  masked_gj_wide_kernel<T><<<grid, warps * 32, smem_bytes(warps),
                             (cudaStream_t)stream>>>(
      (const T*)lhs, (const T*)rhs, (const uint8_t*)passive, (T*)x, k, n,
      stage_lhs ? 1 : 0, (int)(pool_bytes(warps) / sizeof(T)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a launch that was accepted.
int smallk_masked_gj_f32(const void* lhs, const void* rhs, const void* passive,
                         void* x, int k, int n, void* stream, int device) {
  return launch<float>(lhs, rhs, passive, x, k, n, stream, device);
}

int smallk_masked_gj_f64(const void* lhs, const void* rhs, const void* passive,
                         void* x, int k, int n, void* stream, int device) {
  return launch<double>(lhs, rhs, passive, x, k, n, stream, device);
}

int smallk_masked_gj_wide_f32(const void* lhs, const void* rhs,
                              const void* passive, void* x, int k, int n,
                              void* stream, int device) {
  return launch_wide<float>(lhs, rhs, passive, x, k, n, stream, device);
}

int smallk_masked_gj_wide_f64(const void* lhs, const void* rhs,
                              const void* passive, void* x, int k, int n,
                              void* stream, int device) {
  return launch_wide<double>(lhs, rhs, passive, x, k, n, stream, device);
}

const char* smallk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

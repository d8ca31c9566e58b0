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
// What bounds it on the card: at the main path's k = 8 the whole solve is
// O(k^2) bytes in and out per column against O(k^3) flops, so it is bound
// by the latency of the k-step dependency chain (k pivot steps, each a
// divide and a broadcast), not by HBM or the FP units.  At k = 128 the
// (k, k+1) system of one column (66 KB in f32) fills most of a block's
// shared memory and the O(k^3) elimination dominates.
//
// Design:
//   - A CTA takes `cols` columns (a power of two <= 32, as many as fit two
//     CTAs per SM) and holds each column's augmented (k, k+1) system in
//     shared memory, laid out [row][col][column-in-CTA] so that the threads
//     of a warp, which own neighbouring columns, hit neighbouring banks.
//   - LHS is staged in shared memory once per CTA when it fits beside the
//     systems (all f32 ranks; f64 up to k = 120), else read through L1.
//   - threadIdx.x is the column, threadIdx.y a row group: a thread owns rows
//     ty, ty + R, ...  RHS, passive and X are (k, n) row-major, so column j
//     is strided by n and neighbouring threads read neighbouring columns.
//   - tiny is reduced per CTA from LHS on the device: no host sync.
//   - Every product, sum and quotient uses the _rn intrinsics, so no
//     multiply-add is contracted and the result rounds exactly as the
//     plain torch version (kernels/masked_gj.py:masked_gj_solve_reference)
//     does, op for op.
//   - wgmma, TMA and batching the elimination into tensor-core products are
//     later work.

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;     // 227 KB: the most a block may opt into
constexpr size_t kTargetSmem = 96 * 1024;  // leaves room for two CTAs per SM

template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};

template <> struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
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

  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(masked_gj_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = kMaxSmem;
  }
  const dim3 block(cols, R);
  const dim3 grid((unsigned)((n + cols - 1) / cols));
  masked_gj_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)lhs, (const T*)rhs, (const uint8_t*)passive, (T*)x, k, n,
      stage_lhs ? 1 : 0);
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

const char* smallk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
